#!/usr/bin/env python
"""Example/analysis plot generator of the PyTorch port (counterpart of
``generate_examples.py``; reference:
train-pose-estimation_yolo12n/generate_examples.py: annotation
visualizations, dataset statistics, prediction grids). Renders and
predicts on the CUDA card; ``--device cpu`` runs on the host.

The computation (:func:`annotation_batch`, :func:`dataset_statistics`,
:func:`prediction_grid`) needs no plotting library; :func:`draw` writes
the three figures with matplotlib (not on the card's machine: draw where
matplotlib is installed).

  python generate_examples_torch.py --out examples_out --samples 8
  python generate_examples_torch.py --out examples_out --checkpoint ckpts/best_model
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional


def annotation_batch(samples: int, height: int, width: int, seed: int = 0,
                     device=None) -> dict:
    """``samples`` rendered scenes (seed ``seed``) as host numpy arrays:
    images [0,1], masks, corners, has_card."""
    import torch

    from mtg_card_image_segmentation_tpu_torch.data.synthetic import synthetic_batch
    from mtg_card_image_segmentation_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(device)
    b = synthetic_batch(torch.Generator(device=dev).manual_seed(seed), samples, height, width)
    return {k: getattr(b, k).cpu().numpy() for k in ("image", "mask", "corners", "has_card")}


def dataset_statistics(seed: int = 1, n: int = 256, height: int = 96, width: int = 72,
                       device=None) -> dict:
    """The card-area fraction of ``n`` rendered scenes and how many hold a
    card, computed on ``device``."""
    import torch

    from mtg_card_image_segmentation_tpu_torch.data.synthetic import synthetic_batch
    from mtg_card_image_segmentation_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(device)
    b = synthetic_batch(torch.Generator(device=dev).manual_seed(seed), n, height, width)
    has = int(b.has_card.sum())
    return {"area_fractions": b.mask.float().mean(dim=(1, 2)).cpu().numpy(),
            "card": has, "negative": n - has}


def prediction_grid(checkpoint: str, images, device=None) -> dict:
    """The seg checkpoint's (``<dir>/<name>``) predictions and card
    confidence on ``images`` ((B,H,W,3) [0,1] numpy), through the port's
    bf16 model in eval mode on ``device``."""
    import torch

    from mtg_card_image_segmentation_tpu_torch.data.preprocess import normalize_only
    from mtg_card_image_segmentation_tpu_torch.training import checkpoint as ckpt_lib
    from mtg_card_image_segmentation_tpu_torch.utils.params import from_flax
    from mtg_card_image_segmentation_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(device)
    ckpt_dir, name = os.path.split(os.path.normpath(checkpoint))
    params, batch_stats, _ = ckpt_lib.load_params(ckpt_dir or ".", name)
    model = from_flax(params, batch_stats, dtype=torch.bfloat16).to(dev)
    with torch.no_grad():
        logits = model(normalize_only(torch.from_numpy(images).to(dev))).float()
    return {"preds": torch.argmax(logits, -1).cpu().numpy(),
            "confidence": torch.softmax(logits, -1)[..., 1].cpu().numpy()}


def draw(out: str, batch: dict, stats: dict, predictions: Optional[dict] = None) -> List[str]:
    """annotations.png, dataset_stats.png and (with ``predictions``)
    predictions.png under ``out`` (matplotlib, Agg)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from mtg_card_image_segmentation_tpu_torch.utils.plots import plot_predictions

    os.makedirs(out, exist_ok=True)
    imgs, masks, corners, has = (batch[k] for k in ("image", "mask", "corners", "has_card"))
    n = imgs.shape[0]
    cols = min(4, n)
    rows = -(-n // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 4 * rows), squeeze=False)
    for i in range(n):
        ax = axes[i // cols][i % cols]
        ax.imshow(imgs[i])
        ax.contour(masks[i], levels=[0.5], colors="cyan", linewidths=1)
        if has[i]:
            c = corners[i]
            ax.scatter(c[:, 0], c[:, 1], c=["r", "lime", "b", "y"], s=20)
            for k, label in enumerate(["TL", "TR", "BR", "BL"]):
                ax.annotate(label, c[k], color="w", fontsize=7)
        ax.set_title("card" if has[i] else "negative", fontsize=9)
        ax.axis("off")
    fig.tight_layout()
    paths = [os.path.join(out, "annotations.png")]
    fig.savefig(paths[-1], dpi=120)
    plt.close(fig)

    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    axes[0].hist(stats["area_fractions"], bins=30)
    axes[0].set_title(f"card area fraction ({len(stats['area_fractions'])} samples)")
    axes[1].bar(["card", "negative"], [stats["card"], stats["negative"]])
    axes[1].set_title("sample composition")
    fig.tight_layout()
    paths.append(os.path.join(out, "dataset_stats.png"))
    fig.savefig(paths[-1], dpi=120)
    plt.close(fig)

    if predictions is not None:
        paths.append(plot_predictions(imgs, masks, predictions["preds"],
                                      os.path.join(out, "predictions.png"), max_samples=4,
                                      confidences=predictions["confidence"]))
    return paths


def main(argv: Optional[List[str]] = None) -> List[str]:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--out", default="examples_out")
    parser.add_argument("--samples", type=int, default=8)
    parser.add_argument("--height", type=int, default=320)
    parser.add_argument("--width", type=int, default=240)
    parser.add_argument("--checkpoint", default=None,
                        help="seg checkpoint for a prediction grid")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    batch = annotation_batch(args.samples, args.height, args.width, args.seed, args.device)
    stats = dataset_statistics(args.seed + 1, device=args.device)
    preds = (prediction_grid(args.checkpoint, batch["image"], args.device)
             if args.checkpoint else None)
    paths = draw(args.out, batch, stats, preds)
    print(f"examples -> {args.out}/")
    return paths


if __name__ == "__main__":
    main()
