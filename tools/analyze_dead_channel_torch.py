#!/usr/bin/env python
"""Geometry of the HRNet dead-channel eval images (counterpart of
``tools/analyze_dead_channel.py``).

A trained HRNet can give an eval image a corner channel whose global
maximum is near zero (live channels: ~0.94). The shipped decode repairs it
geometrically; this tool asks whether the images that fail are
geometrically extreme or unremarkable:

1. it runs the model over the held-out eval stream
   (``make_decode_fixtures_torch.py``'s, rendered on the device) and finds
   every image whose weakest channel maximum is below ``--dead-conf``;
2. it reports each such image's geometry from its GT corners (rotation,
   sides, aspect, area, border margins, closest corner pair) beside the
   eval set's distribution of the same statistics;
3. it draws a panel per dead image (image, GT corners, per-channel
   maxima) with matplotlib, and writes ``analysis.json`` under ``--out``.

Runs on the CUDA card; ``--device cpu`` runs on the host (with ``--set``
sizes and a short stream, as the tests do). Imports nothing of JAX.

  python tools/analyze_dead_channel_torch.py --checkpoint runs/pose/checkpoints/best_model \\
      --out runs/pose/eval/dead_channel_analysis
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_POPULATION_KEYS = ("rotation_deg", "area_px2", "min_border_margin_px",
                    "min_inter_corner_px", "aspect")


def corner_geometry(gt, h, w):
    """(4,2) GT corners -> geometry dict (rotation, scale, border margins)."""
    import numpy as np

    e_top = gt[1] - gt[0]
    angle = float(np.degrees(np.arctan2(e_top[1], e_top[0])))
    side_t = float(np.linalg.norm(gt[1] - gt[0]))
    side_b = float(np.linalg.norm(gt[2] - gt[3]))
    side_l = float(np.linalg.norm(gt[3] - gt[0]))
    side_r = float(np.linalg.norm(gt[2] - gt[1]))
    area = 0.5 * abs(
        float(
            np.sum(
                gt[:, 0] * np.roll(gt, -1, axis=0)[:, 1]
                - np.roll(gt, -1, axis=0)[:, 0] * gt[:, 1]
            )
        )
    )
    margins = np.minimum.reduce(
        [gt[:, 0], gt[:, 1], w - 1 - gt[:, 0], h - 1 - gt[:, 1]]
    )
    d = np.sqrt(((gt[:, None, :] - gt[None, :, :]) ** 2).sum(-1))
    off = d[~np.eye(4, dtype=bool)]
    return {
        "rotation_deg": angle,
        "sides_px": [side_t, side_r, side_b, side_l],
        "aspect": side_t / max(side_l, 1e-6),
        "area_px2": area,
        "corner_border_margin_px": margins.tolist(),
        "min_border_margin_px": float(margins.min()),
        "min_inter_corner_px": float(off.min()),
    }


def dead_channel_report(chan_max, gt, h: int, w: int, dead_conf: float) -> dict:
    """The JSON report of per-image channel maxima ``chan_max`` (N, K) and
    GT corner pixels ``gt`` (N, 4, 2), numpy: the images whose weakest
    channel is below ``dead_conf``, each with its geometry, beside the
    population's statistics."""
    import numpy as np

    n = chan_max.shape[0]
    weakest = chan_max.min(axis=1)
    geos = [corner_geometry(gt[i], h, w) for i in range(n)]
    pop = {
        k: {
            "mean": float(np.mean([g[k] for g in geos])),
            "p5": float(np.percentile([g[k] for g in geos], 5)),
            "p95": float(np.percentile([g[k] for g in geos], 95)),
            "min": float(np.min([g[k] for g in geos])),
            "max": float(np.max([g[k] for g in geos])),
        }
        for k in _POPULATION_KEYS
    }
    return {
        "num_images": int(n),
        "dead_conf_threshold": dead_conf,
        "dead_channel_images": [
            {"index": int(i), "channel_max": chan_max[i].tolist(),
             "dead_channels": [int(k) for k in np.where(chan_max[i] < dead_conf)[0]],
             "geometry": geos[i]}
            for i in np.where(weakest < dead_conf)[0]],
        "population": pop,
        "weakest_channel_percentiles": {
            "p1": float(np.percentile(weakest, 1)),
            "p5": float(np.percentile(weakest, 5)),
            "p50": float(np.percentile(weakest, 50)),
        },
    }


def analyze(checkpoint: str, out: str, dead_conf: float = 0.2, batches: int = 16,
            batch_size: int = 24, device="cuda", sets=()) -> tuple:
    """The model of ``checkpoint`` (DIR/NAME) over the eval stream on
    ``device``: writes ``<out>/analysis.json`` and returns (report, channel
    maxima (N, K), GT corners (N, 4, 2), {index: image} of the images below
    ``dead_conf``), all on the host."""
    import numpy as np
    import torch

    from make_decode_fixtures_torch import eval_batches
    from mtg_card_image_segmentation_tpu_torch.config import pose_default_config
    from mtg_card_image_segmentation_tpu_torch.training import checkpoint as ckpt_lib
    from mtg_card_image_segmentation_tpu_torch.utils.params import hrnet_from_flax
    from mtg_card_image_segmentation_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(device)
    cfg = pose_default_config()
    if sets:
        cfg = cfg.with_cli(list(sets))
    h, w = cfg.pose.input_height, cfg.pose.input_width
    ckpt_dir, name = os.path.split(os.path.normpath(checkpoint))
    params, batch_stats, _ = ckpt_lib.load_params(ckpt_dir or ".", name)
    model = hrnet_from_flax(params, batch_stats, (cfg.pose.heatmap_height,
                                                 cfg.pose.heatmap_width),
                            dtype=getattr(torch, cfg.pose.compute_dtype)).to(dev).eval()
    chan_max, gts, dead_imgs = [], [], {}
    with torch.inference_mode():
        for images, corners in eval_batches(h, w, dev, batches, batch_size):
            cm = model(images).float().amax(dim=(1, 2)).cpu().numpy()
            # only the images that get a panel stay on the host
            for j in np.where(cm.min(axis=1) < dead_conf)[0]:
                dead_imgs[len(gts) * batch_size + int(j)] = images[j].float().cpu().numpy()
            chan_max.append(cm)
            gts.append(corners.float().cpu().numpy())
    chan_max, gt = np.concatenate(chan_max), np.concatenate(gts)
    report = dead_channel_report(chan_max, gt, h, w, dead_conf)
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "analysis.json"), "w") as f:
        json.dump(report, f, indent=2)
    return report, chan_max, gt, dead_imgs


def draw_panels(out: str, report: dict, dead_imgs: dict, gt, chan_max,
                dead_conf: float) -> List[str]:
    """One diagnostic panel per dead image, ``<out>/dead_<index>.png``."""
    import numpy as np

    from mtg_card_image_segmentation_tpu_torch.utils.plots import _plt

    plt = _plt()
    paths = []
    for entry in report["dead_channel_images"]:
        idx, g = entry["index"], entry["geometry"]
        fig, ax = plt.subplots(figsize=(6, 5))
        ax.imshow(np.clip(dead_imgs[idx], 0, 1))
        gtc = np.vstack([gt[idx], gt[idx][:1]])
        ax.plot(gtc[:, 0], gtc[:, 1], "g-o", ms=4)
        for k in range(4):
            ax.annotate(
                f"ch{k}: {chan_max[idx][k]:.3f}", gt[idx][k],
                color="red" if chan_max[idx][k] < dead_conf else "lime",
                fontsize=8, xytext=(4, 4), textcoords="offset points",
            )
        ax.set_title(
            f"idx {idx}: rot {g['rotation_deg']:.1f}deg, "
            f"margin {g['min_border_margin_px']:.0f}px"
        )
        ax.axis("off")
        fig.tight_layout()
        paths.append(os.path.join(out, f"dead_{idx}.png"))
        fig.savefig(paths[-1], dpi=120)
        plt.close(fig)
    return paths


def main(argv: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--checkpoint", required=True, help="a port checkpoint DIR/NAME")
    parser.add_argument("--out", default="dead_channel_analysis")
    parser.add_argument("--dead-conf", type=float, default=0.2)
    parser.add_argument("--batches", type=int, default=16)
    parser.add_argument("--batch-size", type=int, default=24)
    parser.add_argument("--set", nargs="*", default=[], metavar="a.b=v")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    report, chan_max, gt, dead_imgs = analyze(args.checkpoint, args.out, args.dead_conf,
                                              args.batches, args.batch_size, args.device,
                                              args.set)
    draw_panels(args.out, report, dead_imgs, gt, chan_max, args.dead_conf)
    print(json.dumps(report, indent=2)[:4000])
    print(f"analysis -> {args.out}/")
    return report


if __name__ == "__main__":
    main()
