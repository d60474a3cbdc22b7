#!/usr/bin/env python
"""Freeze the raw model outputs of the decode-tail eval images as small
fixtures (counterpart of ``tools/make_decode_fixtures.py``).

The hardest images of the held-out eval stream, and a few more, are kept
as their raw pre-decode arrays, so that a decode can be held against them
in milliseconds:

- hrnet: the image with the weakest corner channel (the dead-channel tail)
  and the 3 highest-error others under the shipped gated decode. Stored
  per image: (Hh, Hw, K) float16 heatmaps and the GT corner pixels.
- yolo: the image where the ungated joint decode (conf minus collision
  penalty, no plausibility term) errs worst (the flip image) and the 3
  worst others under the shipped decode. Stored per image: decoded (A, 4)
  boxes, (A, 1) scores and (A, K, 3) keypoints, and the GT corner pixels.

The npz keys are the JAX tool's; ``platform`` names the device the model
ran on (the card's name). The eval stream is ``evaluate_pose_torch.py``'s:
batch i rendered on the device from ``torch.Generator`` seed
5,000,000 + i (the port's own renders). The forward is the model in eval
mode at the pose config's compute dtype. Runs on the CUDA card;
``--device cpu`` runs on the host (with ``--set`` sizes and a short
stream, as the tests do). Writes to ``--out`` (default
``runs/decode_fixtures_torch``), never into ``tests/fixtures``, which
holds the JAX package's fixtures. Imports nothing of JAX.

  python tools/make_decode_fixtures_torch.py --family hrnet --checkpoint runs/pose/checkpoints/best_model
  python tools/make_decode_fixtures_torch.py --family yolo  --checkpoint runs/yolo/checkpoints/best_model
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BATCHES, BATCH_SIZE = 16, 24


def eval_batches(h: int, w: int, device, batches: int = BATCHES, batch_size: int = BATCH_SIZE):
    """The held-out eval stream: (images in [0, 1], (B, 4, 2) corner
    pixels) per batch, rendered on ``device``."""
    import torch

    from evaluate_pose_torch import HELD_OUT_SEED
    from mtg_card_image_segmentation_tpu_torch.data.synthetic import synthetic_batch

    for i in range(batches):
        gen = torch.Generator(device=device).manual_seed(HELD_OUT_SEED + i)
        s = synthetic_batch(gen, batch_size, h, w, 0.0, keep_in_frame=True)
        yield s.image, s.corners


def ungated_top1(boxes, scores, kpts):
    """The joint decode's scoring before its plausibility gate (conf minus
    collision penalty): used only to find the flip image; the shipped
    decode is ``models/yolo12_pose.py::top1_detection``."""
    import torch

    from mtg_card_image_segmentation_tpu_torch.models.yolo12_pose import KPT_COLLISION_PX
    from mtg_card_image_segmentation_tpu_torch.ops.heatmap import (
        _first_arg,
        canonicalize_corners,
    )

    dev = kpts.device
    k_dim = kpts.shape[2]
    n_cand = 3
    flat = kpts.transpose(1, 2)  # (B, K, A, 3)
    xy = flat[..., :2]
    masked = flat[..., 2].float()
    picks = []
    for _ in range(n_cand):
        i = _first_arg(masked, 2)
        picks.append(i)
        sel = torch.gather(xy, 2, i[..., None, None].expand(-1, -1, 1, 2))
        d2_a = ((xy - sel) ** 2).sum(-1)
        masked = masked.masked_fill(d2_a < KPT_COLLISION_PX**2, float("-inf"))
    i3 = torch.stack(picks, dim=-1)
    cand = torch.gather(flat, 2, i3[..., None].expand(-1, -1, -1, 3))  # (B, K, n, 3)
    c3 = cand[..., 2]
    digits = []
    for c in range(n_cand**k_dim):
        q, row = c, []
        for _ in range(k_dim):
            row.append(q % n_cand)
            q //= n_cand
        digits.append(row)
    combos = torch.tensor(digits, device=dev)
    kk = torch.arange(k_dim, device=dev)[None, :]
    pick = cand[:, kk, combos, :]  # (B, n^K, K, 3)
    conf_sum = c3[:, kk, combos].sum(-1)
    d2 = ((pick[..., None, :, :2] - pick[..., :, None, :2]) ** 2).sum(-1)
    eye = torch.eye(k_dim, dtype=torch.bool, device=dev)
    penalty = ((d2 < KPT_COLLISION_PX**2) & ~eye).sum(dim=(-1, -2)).float() * 10.0
    best = _first_arg(conf_sum.float() - penalty, 1)
    kp = torch.gather(pick, 1, best[:, None, None, None].expand(-1, 1, k_dim, 3))[:, 0]
    return canonicalize_corners(kp)


def _host(t):
    import numpy as np

    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def hrnet_fixture(hm, gt, h: int, w: int) -> dict:
    """The HRNet fixture of heatmaps ``hm`` (N, Hh, Hw, K) and GT corner
    pixels ``gt`` (N, 4, 2), tensors on any device: ``arrays`` (the npz
    keys but ``platform`` and ``epoch``) and what was chosen. The decode
    runs on the tensors' device, the ranking on the host."""
    import numpy as np
    import torch

    from mtg_card_image_segmentation_tpu_torch.ops import heatmap as hm_lib

    hm = torch.as_tensor(hm)
    hm_np, gt_np = _host(hm).astype(np.float32), _host(gt).astype(np.float32)
    chan_max = hm_np.max(axis=(1, 2))  # (N, K)
    dead_idx = int(chan_max.min(axis=1).argmin())
    coords01, _ = hm_lib.decode_argmax_subpixel_gated(hm)
    px = _host(hm_lib.coords01_to_pixels(coords01, (h, w)))
    err = np.sqrt(((px - gt_np) ** 2).sum(-1)).max(axis=1)  # (N,)
    order = [int(i) for i in np.argsort(-err) if i != dead_idx][:3]
    keep = [dead_idx] + order
    return {"arrays": {"heatmaps": hm_np[keep].astype(np.float16),
                       "gt_corners": gt_np[keep],
                       "indices": np.asarray(keep, np.int32),
                       "dead_channel_conf": chan_max[dead_idx].astype(np.float32),
                       "image_hw": np.asarray([h, w], np.int32)},
            "dead_idx": dead_idx, "worst3": order, "err_px": err[keep]}


def yolo_fixture(boxes, scores, kpts, gt) -> dict:
    """The YOLO fixture of decoded outputs ``boxes`` (N, A, 4), ``scores``
    (N, A, 1), ``kpts`` (N, A, K, 3) and GT corner pixels ``gt`` (N, 4, 2),
    tensors on any device: ``arrays`` (the npz keys but ``platform``,
    ``epoch`` and ``image_hw``) and what was chosen. The decodes run on the
    tensors' device, the ranking on the host."""
    import numpy as np
    import torch

    from mtg_card_image_segmentation_tpu_torch.models.yolo12_pose import top1_detection

    boxes, scores, kpts = (torch.as_tensor(t) for t in (boxes, scores, kpts))
    gt_np = _host(gt).astype(np.float32)
    kp_old = _host(ungated_top1(boxes, scores, kpts))[..., :2]
    err_old = np.sqrt(((kp_old - gt_np) ** 2).sum(-1)).max(axis=1)
    flip_idx = int(err_old.argmax())
    kp_new = _host(top1_detection(boxes, scores, kpts)[2])[..., :2]
    err_new = np.sqrt(((kp_new - gt_np) ** 2).sum(-1)).max(axis=1)
    order = [int(i) for i in np.argsort(-err_new) if i != flip_idx][:3]
    keep = [flip_idx] + order
    return {"arrays": {
                # coordinates stay float32 (fp16 has ~0.5 px ulp at 640)
                "boxes": _host(boxes)[keep].astype(np.float32),
                "scores": _host(scores)[keep].astype(np.float16),
                "kpts": _host(kpts)[keep].astype(np.float32),
                "gt_corners": gt_np[keep],
                "indices": np.asarray(keep, np.int32),
                "ungated_err_px": err_old[keep].astype(np.float32)},
            "flip_idx": flip_idx, "worst3": order,
            "ungated_err_px": float(err_old[flip_idx]), "gated_err_px": float(err_new[flip_idx])}


def main(argv: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--family", choices=["hrnet", "yolo"], required=True)
    parser.add_argument("--checkpoint", required=True, help="a port checkpoint DIR/NAME")
    parser.add_argument("--out", default="runs/decode_fixtures_torch")
    parser.add_argument("--imgsz", type=int, default=640)
    parser.add_argument("--batches", type=int, default=BATCHES)
    parser.add_argument("--batch-size", type=int, default=BATCH_SIZE)
    parser.add_argument("--set", nargs="*", default=[], metavar="a.b=v")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from mtg_card_image_segmentation_tpu_torch.config import pose_default_config
    from mtg_card_image_segmentation_tpu_torch.training import checkpoint as ckpt_lib
    from mtg_card_image_segmentation_tpu_torch.utils.params import hrnet_from_flax, yolo_from_flax
    from mtg_card_image_segmentation_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)
    cfg = pose_default_config()
    if args.set:
        cfg = cfg.with_cli(args.set)
    ckpt_dir, name = os.path.split(os.path.normpath(args.checkpoint))
    params, batch_stats, meta = ckpt_lib.load_params(ckpt_dir or ".", name)
    dtype = getattr(torch, cfg.pose.compute_dtype)
    platform = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    os.makedirs(args.out, exist_ok=True)
    stream = dict(batches=args.batches, batch_size=args.batch_size)

    if args.family == "hrnet":
        h, w = cfg.pose.input_height, cfg.pose.input_width
        model = hrnet_from_flax(params, batch_stats,
                                (cfg.pose.heatmap_height, cfg.pose.heatmap_width),
                                dtype=dtype).to(device).eval()
        hms, gts = [], []
        with torch.inference_mode():
            for images, corners in eval_batches(h, w, device, **stream):
                hms.append(model(images).float())
                gts.append(corners.float())
        outputs = {"hm": torch.cat(hms), "gt": torch.cat(gts)}
        fx = hrnet_fixture(outputs["hm"], outputs["gt"], h, w)
        path = os.path.join(args.out, "hrnet_decode_fixture.npz")
        print(f"hrnet fixture: dead idx {fx['dead_idx']} "
              f"chan_max={fx['arrays']['dead_channel_conf']} worst3={fx['worst3']} "
              f"errs={fx['err_px']} platform={platform}")
    else:
        h = w = args.imgsz
        model = yolo_from_flax(params, batch_stats, dtype=dtype).to(device).eval()
        parts = {"boxes": [], "scores": [], "kpts": [], "gt": []}
        with torch.inference_mode():
            for images, corners in eval_batches(h, w, device, **stream):
                for key, t in zip(("boxes", "scores", "kpts", "gt"), (*model(images), corners)):
                    parts[key].append(t.float())
        outputs = {k: torch.cat(v) for k, v in parts.items()}
        fx = yolo_fixture(outputs["boxes"], outputs["scores"], outputs["kpts"], outputs["gt"])
        fx["arrays"]["image_hw"] = np.asarray([h, w], np.int32)
        path = os.path.join(args.out, "yolo_decode_fixture.npz")
        print(f"yolo fixture: flip idx {fx['flip_idx']} "
              f"ungated_err={fx['ungated_err_px']:.1f}px gated_err={fx['gated_err_px']:.1f}px "
              f"worst3={fx['worst3']} platform={platform}")
    np.savez_compressed(path, **fx["arrays"], platform=np.asarray(platform),
                        epoch=np.asarray(int(meta.get("epoch", -1))))
    return {"family": args.family, "path": path, "platform": platform,
            "indices": [int(i) for i in fx["arrays"]["indices"]], "outputs": outputs}


if __name__ == "__main__":
    main()
