"""Graft entry of the PyTorch port (counterpart of ``__graft_entry__.py``).

- ``entry(device="cuda")``: the flagship model's forward, LR-ASPP
  MobileNetV3-Large (bf16 compute) at the reference's 320x240 operating
  point in eval mode, from Flax-like seeded weights
  (``utils/params.py::init_flax_like(0)``), as ``(fn, example_args)``.
- ``dryrun_multichip(n)``: the port's three distributed programs on ``n``
  ``gloo`` ranks on the host, over an ``(data=n/2, space=2)`` mesh when
  ``n`` is even (``(data=n)`` otherwise), at the JAX dry run's shapes: the
  bf16 seg train step at 64x48 (data parallelism with the rows of every
  image split over the space axis), the HRNet train step at 64x64 with
  16x16 heatmaps, and ``SegPredictor`` on uint8 64x48 split over two host
  devices through the plain kernel versions. It checks finite losses and
  the mask shape, and returns None.

The dry run is hermetic, as the JAX contract demands: its ranks are
subprocesses that see no CUDA device (``CUDA_VISIBLE_DEVICES=""``), so it
touches no card, whatever this process has initialised.

    python -c "import graft_entry_torch as g; fn, args = g.entry(); fn(*args)"
    python -c "import graft_entry_torch as g; g.dryrun_multichip(4)"
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from typing import Optional

ROOT = os.path.dirname(os.path.abspath(__file__))
DRYRUN_TIMEOUT = 600


def entry(device: Optional[str] = "cuda"):
    """Return ``(fn, (model, example))``: ``fn(model, images)`` is the
    model's eval forward without autograd, (B, 320, 240, 3) normalized
    images -> (B, 320, 240, 2) float32 logits, on ``device`` (the card
    unless the caller asks for the CPU)."""
    import torch

    from mtg_card_image_segmentation_tpu_torch.utils.params import (
        init_flax_like,
        trainable_from_flax,
    )
    from mtg_card_image_segmentation_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(device)
    model = trainable_from_flax(*init_flax_like(0), dtype=torch.bfloat16).to(dev).eval()
    example = torch.zeros((1, 320, 240, 3), dtype=torch.float32, device=dev)

    def fn(model, images):
        with torch.no_grad():
            return model(images)

    return fn, (model, example)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int) -> None:
    """Run the three programs on ``n_devices`` gloo ranks on the host (see
    the module docstring); raises when a rank fails."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["CUDA_VISIBLE_DEVICES"] = ""
    code = ("import sys, graft_entry_torch as g; "
            "g._dryrun_rank(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]))")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(n_devices), str(port)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(n_devices)]
    try:
        outs = [p.communicate(timeout=DRYRUN_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [(r, p.returncode, out[-3000:]) for r, (p, out) in enumerate(zip(procs, outs))
              if p.returncode != 0]
    if failed:
        raise RuntimeError(f"dryrun_multichip({n_devices}): ranks failed: {failed}")


def _dryrun_rank(rank: int, world: int, port: int) -> None:
    """One rank of :func:`dryrun_multichip`."""
    import numpy as np
    import torch

    from mtg_card_image_segmentation_tpu_torch.config import OptimizerConfig
    from mtg_card_image_segmentation_tpu_torch.models.hrnet import HRNetPose
    from mtg_card_image_segmentation_tpu_torch.models.lraspp import CardSegmentationModel
    from mtg_card_image_segmentation_tpu_torch.parallel import distributed, make_mesh, shard_batch
    from mtg_card_image_segmentation_tpu_torch.serving.predictor import SegPredictor
    from mtg_card_image_segmentation_tpu_torch.training.loop import (
        make_pose_train_step,
        make_train_step,
    )
    from mtg_card_image_segmentation_tpu_torch.training.optim import create_optimizer
    from mtg_card_image_segmentation_tpu_torch.training.state import create_seg_state
    from mtg_card_image_segmentation_tpu_torch.utils.params import init_flax_defaults

    assert not torch.cuda.is_available(), "the dry run must see no CUDA device"
    torch.set_num_threads(2)
    distributed.initialize(f"localhost:{port}", world, rank, device="cpu")
    space = 2 if world % 2 == 0 and world > 1 else 1
    mesh = make_mesh(data=world // space, space=space, devices=["cpu"])
    data = mesh.shape["data"]
    cpu = torch.device("cpu")

    def my_rows(*arrays):
        """This rank's data shard of global host arrays, then its rows."""
        n = arrays[0].shape[0] // data
        i = rank // space
        parts = [torch.from_numpy(a[i * n:(i + 1) * n]) for a in arrays]
        return shard_batch(mesh, *parts)[0]

    # 1) the bf16 seg train step, data x space parallel
    opt_def, _ = create_optimizer(OptimizerConfig(), num_epochs=1, steps_per_epoch=1)
    state = create_seg_state(init_flax_defaults(CardSegmentationModel(), 0), opt_def, cpu)
    batch = max(world, 2 * data)
    rng = np.random.default_rng(0)
    images = rng.standard_normal((batch, 64, 48, 3)).astype(np.float32)
    masks = (images[..., 0] > 0).astype(np.int32)
    state, stats = make_train_step(mesh=mesh)(state, *my_rows(images, masks))

    # 2) the HRNet pose train step on the same mesh
    pose_state = create_seg_state(
        init_flax_defaults(HRNetPose(heatmap_height=16, heatmap_width=16), 1), opt_def, cpu)
    pose_images = rng.random((batch, 64, 64, 3)).astype(np.float32)
    pose_targets = rng.random((batch, 16, 16, 4)).astype(np.float32)
    pose_state, pose_stats = make_pose_train_step(mesh=mesh)(
        pose_state, *my_rows(pose_images, pose_targets))

    # 3) batch-split serving over two host devices, the plain kernel versions
    variables = state.variables()
    predictor = SegPredictor(variables["params"], variables["batch_stats"], 64, 48,
                             mesh=make_mesh(devices=["cpu", "cpu"]))
    serve_batch = data * 2
    images_u8 = rng.integers(0, 256, (serve_batch, 64, 48, 3)).astype(np.uint8)
    mask = predictor.predict(images_u8)
    assert tuple(mask.shape) == (serve_batch, 64, 48), mask.shape

    assert np.isfinite(float(stats["loss"])), "non-finite loss in dryrun"
    assert np.isfinite(float(pose_stats["loss"])), "non-finite pose loss in dryrun"
    distributed.barrier()
    torch.distributed.destroy_process_group()
    if rank == 0:
        print(f"dryrun_multichip({world}): mesh {mesh.shape}, seg loss "
              f"{float(stats['loss']):.6f}, pose loss {float(pose_stats['loss']):.6f}, "
              f"masks {tuple(mask.shape)}", flush=True)
