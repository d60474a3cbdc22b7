"""The evaluator's prediction panels (reference train/evaluate.py:170-238;
copy of ``plot_predictions`` from the JAX package's ``utils/plots.py``; its
training-history plot waits for ``train_seg_torch.py --plot``).
Headless matplotlib (Agg), imported only when a plot is drawn."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_predictions(
    images: np.ndarray,
    masks: np.ndarray,
    preds: np.ndarray,
    out_path: str,
    max_samples: int = 4,
    confidences: Optional[np.ndarray] = None,
) -> str:
    """Rows of [image | ground truth | prediction | (confidence)] — the
    evaluator's 4-panel analysis plot (train/evaluate.py:170-238)."""
    plt = _plt()
    n = min(max_samples, images.shape[0])
    cols = 4 if confidences is not None else 3
    fig, axes = plt.subplots(n, cols, figsize=(3 * cols, 3 * n), squeeze=False)
    for i in range(n):
        img = images[i]
        img = (img - img.min()) / (img.max() - img.min() + 1e-8)
        axes[i][0].imshow(img)
        axes[i][0].set_title("image")
        axes[i][1].imshow(masks[i], cmap="gray", vmin=0, vmax=1)
        axes[i][1].set_title("ground truth")
        axes[i][2].imshow(preds[i], cmap="gray", vmin=0, vmax=1)
        axes[i][2].set_title("prediction")
        if confidences is not None:
            im = axes[i][3].imshow(confidences[i], cmap="viridis", vmin=0, vmax=1)
            axes[i][3].set_title("card confidence")
            fig.colorbar(im, ax=axes[i][3], fraction=0.046)
        for ax in axes[i]:
            ax.axis("off")
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_confusion_matrix(cm: np.ndarray, out_path: str, class_names=None) -> str:
    """Confusion-matrix heatmap (train/evaluate.py:139-168)."""
    plt = _plt()
    cm = np.asarray(cm, dtype=np.float64)
    norm = cm / np.maximum(cm.sum(axis=1, keepdims=True), 1.0)
    names = class_names or (["background", "card"] if cm.shape[0] == 2 else None)
    fig, ax = plt.subplots(figsize=(5, 4))
    im = ax.imshow(norm, cmap="Blues", vmin=0, vmax=1)
    for i in range(cm.shape[0]):
        for j in range(cm.shape[1]):
            ax.text(
                j, i, f"{int(cm[i, j]):,}\n({norm[i, j]:.1%})",
                ha="center", va="center",
                color="white" if norm[i, j] > 0.5 else "black", fontsize=9,
            )
    if names:
        ax.set_xticks(range(len(names)), names)
        ax.set_yticks(range(len(names)), names)
    ax.set_xlabel("predicted")
    ax.set_ylabel("actual")
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
