#!/usr/bin/env python
"""Data-parallel seg training and batch-split serving across N cards.

    python -m torch.distributed.run --nproc_per_node=N tools/distributed_step_torch.py \
        [--batch 32] [--size 320 240] [--steps 10]          (needs N CUDA cards)
    python -m torch.distributed.run --nproc_per_node=4 tools/distributed_step_torch.py \
        --device cpu --size 64 48 --batch 2 --steps 2       (N gloo ranks on the host)

Rank 0 first measures the references on its own card, before any rank
joins the process group (the global BatchNorm and the all-reduced loss run
whenever a group is up): the plain fp32 seg train step (the seg config's
model from Flax's default init, seed 0; SGD 0.05; TF32 off, cuDNN
deterministic) on the global batch of N x ``--batch`` images (smooth
normal fields from a numpy seed, masks where the red channel is positive)
and its float64 step; the median ms of the plain step at the local batch;
and ``SegPredictor`` at N x ``--batch`` split over all N cards
(``make_mesh()``) against one card: masks equal, ms per call of each.

Then every rank joins (``parallel/distributed.py::initialize``: ``nccl``,
or ``gloo`` with ``--device cpu``) and runs the step on its slice of the
same batch, in float64 and in fp32: the float64 step's gradients and
BatchNorm statistics must lie within 1e-9 of the float64 plain step's
(each tensor's largest entry, floored at 1e-5 of the model's largest
gradient), the fp32 loss within 1e-6 of the plain step's, the fp32
gradients and statistics no further from the float64 step than twice the
plain step's distance (``tests/test_torch_distributed.py``'s rules), every
rank must hold the same gradients; and its median fp32 step ms.
Rank 0 prints one JSON line with the card's name and power limit (or the
host's), and the process exits non-zero when a check fails. Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SGD = dict(name="sgd", schedule="constant", warmup_epochs=0, learning_rate=0.05)
FP32_FACTOR = 2.0
LOSS_REL = 1e-6
FLOAT64_REL = 1e-9


def batch(n: int, h: int, w: int, seed: int = 0):
    """(images NHWC float32, masks int32) on the host."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    base = torch.from_numpy(rng.standard_normal((n, 3, h // 8, w // 8)).astype(np.float32))
    imgs = torch.nn.functional.interpolate(base, size=(h, w), mode="bilinear",
                                           align_corners=False).permute(0, 2, 3, 1).contiguous()
    return imgs, (imgs[..., 0] > 0).to(torch.int32)


def state_of(device, float64: bool = False):
    import torch

    from mtg_card_image_segmentation_tpu_torch.config import ModelConfig, OptimizerConfig
    from mtg_card_image_segmentation_tpu_torch.models import registry
    from mtg_card_image_segmentation_tpu_torch.training.loop import float64_copy
    from mtg_card_image_segmentation_tpu_torch.training.optim import create_optimizer
    from mtg_card_image_segmentation_tpu_torch.training.state import create_seg_state
    from mtg_card_image_segmentation_tpu_torch.utils.params import init_flax_defaults

    model = init_flax_defaults(registry.from_config(ModelConfig(compute_dtype="float32")), 0)
    if float64:
        model = float64_copy(model)
    opt_def, _ = create_optimizer(OptimizerConfig(**SGD), 1, 10)
    return create_seg_state(model, opt_def, torch.device(device))


def record(state, stats) -> dict:
    out = {"loss": float(stats["loss"])}
    out.update({f"grad/{n}": p.grad.double().cpu().numpy()
                for n, p in state.model.named_parameters()})
    out.update({f"buffer/{n}": b.double().cpu().numpy()
                for n, b in state.model.named_buffers() if "running" in n})
    return out


def distance(rec: dict, ref: dict, prefix: str) -> float:
    """The worst tensor's max|rec - ref| over its largest |ref|, floored at
    1e-5 of the largest entry of all."""
    import numpy as np

    keys = [k for k in ref if k.startswith(prefix)]
    top = max(float(np.abs(ref[k]).max()) for k in keys)
    return max(float(np.abs(rec[k] - ref[k]).max()) / max(float(np.abs(ref[k]).max()),
                                                          1e-5 * top) for k in keys)


def median_ms(sync, fn, n: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def references(args, world: int, device) -> dict:
    """Rank 0's measurements before the group exists (see the module
    docstring)."""
    import torch

    from mtg_card_image_segmentation_tpu_torch.parallel import make_mesh
    from mtg_card_image_segmentation_tpu_torch.serving.predictor import SegPredictor
    from mtg_card_image_segmentation_tpu_torch.training.loop import (
        float64_casts,
        make_train_step,
    )
    from mtg_card_image_segmentation_tpu_torch.utils.params import init_flax_like

    h, w = args.size
    imgs, masks = batch(world * args.batch, h, w)
    step = make_train_step()
    state = state_of(device)
    _, stats = step(state, imgs.to(device), masks.to(device))
    out = {"plain": record(state, stats)}
    with float64_casts():
        state = state_of(device, float64=True)
        _, stats = step(state, imgs.to(device).double(), masks.to(device))
        out["exact"] = record(state, stats)
    del state
    local = (imgs[:args.batch].to(device), masks[:args.batch].to(device))
    state = state_of(device)
    out["plain_local_step_ms"] = median_ms(args.sync, lambda: step(state, *local), args.steps)
    del state
    # batch-split serving over every card against one card
    cards = make_mesh(devices=[args.device] * world if args.device == "cpu" else None)
    weights = init_flax_like(0)
    u8 = (torch.rand((world * args.batch, h, w, 3), generator=torch.Generator().manual_seed(1))
          * 255).to(torch.uint8)
    split = SegPredictor(*weights, h, w, mesh=cards)
    one = SegPredictor(*weights, h, w, device=device)
    out["serving"] = {"devices": [str(d) for d in cards.devices], "batch": world * args.batch,
                      "masks_equal": bool(torch.equal(split.predict(u8).cpu(),
                                                      one.predict(u8).cpu())),
                      "split_ms": median_ms(args.sync, lambda: split.predict(u8), args.steps),
                      "one_device_ms": median_ms(args.sync, lambda: one.predict(u8), args.steps)}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--batch", type=int, default=32, help="local batch per rank")
    parser.add_argument("--size", type=int, nargs=2, default=(320, 240), metavar=("H", "W"))
    parser.add_argument("--steps", type=int, default=10, help="timed steps / calls")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    import torch

    from mtg_card_image_segmentation_tpu_torch.parallel import distributed, make_mesh
    from mtg_card_image_segmentation_tpu_torch.training.loop import (
        float64_casts,
        make_train_step,
    )
    from mtg_card_image_segmentation_tpu_torch.utils.platform import (
        nvidia_smi_name_power,
        resolve_device,
    )

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if args.device == "cuda":
        resolve_device("cuda")
        torch.cuda.set_device(local_rank)
        device = torch.device("cuda", local_rank)
        args.sync = torch.cuda.synchronize
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
    else:
        device = torch.device("cpu")
        args.sync = lambda: None
        torch.set_num_threads(2)
    refs = references(args, world, device) if rank == 0 else None

    distributed.initialize(device=args.device)
    h, w = args.size
    imgs, masks = batch(world * args.batch, h, w)
    lo, hi = rank * args.batch, (rank + 1) * args.batch
    mine = (imgs[lo:hi].to(device), masks[lo:hi].to(device))
    step = make_train_step(mesh=make_mesh(devices=[device]))
    with float64_casts():
        state = state_of(device, float64=True)
        _, stats = step(state, mine[0].double(), mine[1])
        rec64 = record(state, stats)
    state = state_of(device)
    _, stats = step(state, *mine)
    rec = record(state, stats)
    grads = torch.cat([p.grad.flatten() for p in state.model.parameters()])
    gathered = distributed.all_gather_cat(grads[None])
    same = bool((gathered == gathered[0]).all())
    step_ms = median_ms(args.sync, lambda: step(state, *mine), args.steps)
    distributed.barrier()
    torch.distributed.destroy_process_group()
    if rank != 0:
        return 0

    plain, exact = refs["plain"], refs["exact"]
    row = {"tool": "distributed_step", "ranks": world, "device": args.device,
           "backend": "nccl" if args.device == "cuda" else "gloo", "size": [h, w],
           "local_batch": args.batch, "global_batch": world * args.batch,
           "loss_plain": plain["loss"], "loss_rel": abs(rec["loss"] - plain["loss"])
           / abs(plain["loss"]), "ranks_hold_the_same_gradients": same,
           "float64_vs_plain_float64": {p[:-1]: distance(rec64, exact, p)
                                        for p in ("grad/", "buffer/")},
           **{f"{p[:-1]}_distance_from_float64": {"plain": distance(plain, exact, p),
                                                  "data_parallel": distance(rec, exact, p)}
              for p in ("grad/", "buffer/")},
           "plain_local_step_ms": refs["plain_local_step_ms"],
           "data_parallel_step_ms": step_ms,
           "img_per_s": {"plain_one_device": args.batch * 1e3 / refs["plain_local_step_ms"],
                         "data_parallel": world * args.batch * 1e3 / step_ms},
           "scaling_efficiency": refs["plain_local_step_ms"] / step_ms,
           "serving": refs["serving"],
           "card": torch.cuda.get_device_name(0) if args.device == "cuda" else "host CPU",
           "nvidia_smi": nvidia_smi_name_power() if args.device == "cuda" else None,
           "tolerance": {"loss_rel": LOSS_REL, "fp32_factor": FP32_FACTOR,
                         "float64_rel": FLOAT64_REL}}
    print(json.dumps(row), flush=True)
    bad = [f"loss {rec['loss']} vs plain {plain['loss']}"] if row["loss_rel"] > LOSS_REL else []
    bad += [f"float64 {k}: {v}" for k, v in row["float64_vs_plain_float64"].items()
            if v > FLOAT64_REL]
    bad += [f"{p[:-1]}: {row[f'{p[:-1]}_distance_from_float64']}" for p in ("grad/", "buffer/")
            if row[f"{p[:-1]}_distance_from_float64"]["data_parallel"]
            > FP32_FACTOR * row[f"{p[:-1]}_distance_from_float64"]["plain"]]
    if not same:
        bad.append("the ranks hold different gradients")
    if not refs["serving"]["masks_equal"]:
        bad.append("the split predictor's masks differ from one device's")
    if bad:
        print(f"distributed_step: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
