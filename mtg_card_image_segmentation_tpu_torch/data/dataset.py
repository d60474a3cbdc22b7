"""Filesystem dataset: the reference's on-disk contract (a copy of the JAX
package's ``data/dataset.py``, which imports no framework; the port keeps
its own copy so that it imports nothing of the JAX package, and
``tests/test_torch_data_pipeline.py`` holds the two equal).

Layout (train/README.md:69-86, train/dataset.py:37-62):
    dataset/{train,test}/images/*.jpg|png   RGB photos
    dataset/{train,test}/masks/*.png        binary masks (card=255)
    dataset/corner_annotations.json         {split: {filename: [[x,y]*4]}}

Decode happens on host (cv2); everything downstream (resize/normalize/
augment) is on-device — see data/preprocess.py and data/pipeline.py.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def _cv2():
    import cv2

    return cv2


class CardSegmentationDataset:
    """Image/mask pair dataset. Masks binarized at >127 on device."""

    def __init__(self, image_dir: str, mask_dir: str) -> None:
        self.image_dir = image_dir
        self.mask_dir = mask_dir
        names = sorted(
            f for f in os.listdir(image_dir) if f.lower().endswith(_IMG_EXTS)
        )
        self.items: List[Tuple[str, str]] = []
        missing = 0
        for name in names:
            stem = os.path.splitext(name)[0]
            mask_path = None
            for ext in (".png", ".jpg"):
                cand = os.path.join(mask_dir, stem + ext)
                if os.path.exists(cand):
                    mask_path = cand
                    break
            if mask_path is None:
                missing += 1
                continue
            self.items.append((os.path.join(image_dir, name), mask_path))
        if missing:
            print(f"[dataset] warning: {missing} images without masks skipped")
        if not self.items:
            raise FileNotFoundError(
                f"No image/mask pairs under {image_dir} / {mask_dir}"
            )

    def __len__(self) -> int:
        return len(self.items)

    def load_raw(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (H, W, 3) RGB uint8 + (H, W) uint8 mask."""
        cv2 = _cv2()
        img_path, mask_path = self.items[idx]
        img = cv2.imread(img_path, cv2.IMREAD_COLOR)
        if img is None:
            raise IOError(f"Failed to decode {img_path}")
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        mask = cv2.imread(mask_path, cv2.IMREAD_GRAYSCALE)
        if mask is None:
            raise IOError(f"Failed to decode {mask_path}")
        if mask.shape[:2] != img.shape[:2]:
            mask = cv2.resize(
                mask, (img.shape[1], img.shape[0]), interpolation=cv2.INTER_NEAREST
            )
        return img, mask


def load_corner_annotations(path: str) -> Dict[str, Dict[str, list]]:
    """corner_annotations.json as written by data/corners.py (and by the
    reference's preprocess_masks.py:225-285)."""
    with open(path) as f:
        return json.load(f)


class CornerDataset:
    """Image + 4-corner keypoint dataset riding on the same directory layout
    (behavioral spec: train-pose-estimation_custom/dataset.py:208-343)."""

    def __init__(
        self,
        image_dir: str,
        annotations: Dict[str, list],
    ) -> None:
        self.image_dir = image_dir
        self.items = [
            (os.path.join(image_dir, name), np.asarray(corners, np.float32))
            for name, corners in sorted(annotations.items())
            if os.path.exists(os.path.join(image_dir, name))
            and np.asarray(corners).shape == (4, 2)
        ]
        if not self.items:
            raise FileNotFoundError(f"No annotated images under {image_dir}")

    def __len__(self) -> int:
        return len(self.items)

    def load_raw(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (H, W, 3) RGB uint8 + (4, 2) float32 pixel corners."""
        cv2 = _cv2()
        img_path, corners = self.items[idx]
        img = cv2.imread(img_path, cv2.IMREAD_COLOR)
        if img is None:
            raise IOError(f"Failed to decode {img_path}")
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB), corners.copy()
