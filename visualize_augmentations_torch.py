#!/usr/bin/env python
"""Augmentation visualizer of the PyTorch port (counterpart of
``visualize_augmentations.py``; reference:
train-pose-estimation_custom/visualize_augmentations.py). Renders and
augments on the CUDA card; ``--device cpu`` runs on the host.

Renders grids of augmented samples (images, mask contours, keypoint
overlays) for eyeballing the on-device augmentation suite. The samples are
computed by :func:`augmented_samples`, which needs no plotting library;
:func:`draw_grid` draws them with matplotlib (not on the card's machine:
run the drawing where matplotlib is installed).

  python visualize_augmentations_torch.py --samples 4 --variants 5 --out aug_grid.png
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

FLIP_IDX = (1, 0, 3, 2)


def augmented_samples(samples: int, variants: int, height: int, width: int,
                      keypoints: bool = False, seed: int = 0, device=None) -> List[dict]:
    """Per row: the rendered ``original`` (H,W,3) float32 [0,1] and its
    ``variants`` augmentations (``images``, ``masks`` and, with
    ``keypoints``, the moved corners), as host numpy arrays. Row r's scene is
    drawn from seed ``seed + r`` and its c-th augmentation from ``1000 (r+1)
    + c``, each a ``torch.Generator`` on ``device``."""
    import numpy as np
    import torch

    from mtg_card_image_segmentation_tpu_torch.config import AugmentConfig
    from mtg_card_image_segmentation_tpu_torch.data.augment import augment_sample, draw_augment
    from mtg_card_image_segmentation_tpu_torch.data.synthetic import synthetic_sample
    from mtg_card_image_segmentation_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(device)
    cfg = AugmentConfig()
    rows = []
    for r in range(samples):
        s = synthetic_sample(torch.Generator(device=dev).manual_seed(seed + r), height, width,
                             0.0)
        row = {"original": s.image.cpu().numpy(), "images": [], "masks": [], "keypoints": []}
        for c in range(1, variants + 1):
            gen = torch.Generator(device=dev).manual_seed(1000 * (r + 1) + c)
            draws = draw_augment(gen, 1, height, width, cfg, keypoints=keypoints)
            out = augment_sample(draws, s.image, s.mask, cfg,
                                 keypoints=s.corners if keypoints else None,
                                 flip_idx=FLIP_IDX if keypoints else None)
            row["images"].append(out.image.cpu().numpy())
            row["masks"].append(out.mask.cpu().numpy())
            row["keypoints"].append(None if out.keypoints is None
                                    else out.keypoints.cpu().numpy())
        row["images"] = np.stack(row["images"])
        row["masks"] = np.stack(row["masks"])
        rows.append(row)
    return rows


def draw_grid(rows: List[dict], out: str) -> str:
    """The grid of :func:`augmented_samples` as a PNG (matplotlib, Agg)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cols = rows[0]["images"].shape[0] + 1
    fig, axes = plt.subplots(len(rows), cols, figsize=(2.2 * cols, 2.8 * len(rows)),
                             squeeze=False)
    for r, row in enumerate(rows):
        axes[r][0].imshow(row["original"])
        axes[r][0].set_title("original", fontsize=8)
        for c in range(1, cols):
            axes[r][c].imshow(row["images"][c - 1])
            axes[r][c].contour(row["masks"][c - 1], levels=[0.5], colors="cyan",
                               linewidths=1)
            k = row["keypoints"][c - 1]
            if k is not None:
                axes[r][c].scatter(k[:, 0], k[:, 1], c=["r", "lime", "b", "y"], s=14)
            axes[r][c].set_title(f"aug {c}", fontsize=8)
        for ax in axes[r]:
            ax.axis("off")
    fig.tight_layout()
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    fig.savefig(out, dpi=120)
    plt.close(fig)
    return out


def main(argv: Optional[List[str]] = None) -> str:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--samples", type=int, default=4)
    parser.add_argument("--variants", type=int, default=5)
    parser.add_argument("--height", type=int, default=160)
    parser.add_argument("--width", type=int, default=120)
    parser.add_argument("--keypoints", action="store_true",
                        help="keypoint-aware pipeline (affine only) with corner overlay")
    parser.add_argument("--out", default="augmentation_grid.png")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    rows = augmented_samples(args.samples, args.variants, args.height, args.width,
                             args.keypoints, args.seed, args.device)
    out = draw_grid(rows, args.out)
    print(f"augmentation grid -> {out}")
    return out


if __name__ == "__main__":
    main()
