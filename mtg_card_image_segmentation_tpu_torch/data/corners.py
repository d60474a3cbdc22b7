"""Mask -> 4-corner derivation + corner_annotations.json writer (a copy of
the JAX package's framework-free ``data/corners.py``, numpy + cv2).

Behavioral spec: train/preprocess_masks.py — find the card quadrilateral in
a binary mask and emit corners clockwise from top-left; fallback chain when
a clean quad isn't found (:131-194); writes dataset-level
corner_annotations.json (:225-285).

Algorithm (own design, cv2 geometry): largest contour -> approxPolyDP over
an epsilon sweep looking for a convex quad -> fallback to the min-area
rectangle of the contour (more robust than the reference's Hough-line
intersection on synthetic masks) -> canonical TL,TR,BR,BL ordering.

Ordering convention note: derivation orders corners in the IMAGE frame
(top-left of the image), exactly like the reference's preprocess_masks.py —
a mask cannot reveal the card's orientation. The synthetic renderer
(data/synthetic.py) instead emits CARD-frame corners (the card's own
top-left under any rotation), which is strictly more informative ground
truth for pose training. The two agree up to a cyclic rotation of the quad.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np


def order_corners(pts: np.ndarray) -> np.ndarray:
    """(4, 2) xy -> clockwise from top-left (preprocess_masks.py:196-223
    contract). Centroid-angle sort (ascending atan2 = clockwise with y
    down) rolled so TL = min(x+y) comes first — always a true permutation,
    unlike the classic sum/diff rule which picks the same point twice on
    quads rotated near 45°. Must stay in lockstep with
    data/synthetic.py canonicalize_corners (the tensor twin)."""
    pts = np.asarray(pts, np.float32).reshape(4, 2)
    c = pts.mean(axis=0)
    pts = pts[np.argsort(np.arctan2(pts[:, 1] - c[1], pts[:, 0] - c[0]))]
    start = int(np.argmin(pts.sum(axis=1)))
    return np.roll(pts, -start, axis=0)


def find_card_corners(
    mask: np.ndarray, min_area: float = 100.0
) -> Optional[np.ndarray]:
    """Binary (H, W) mask -> (4, 2) float32 corners TL,TR,BR,BL or None."""
    import cv2

    binary = (np.asarray(mask) > 127).astype(np.uint8) * 255 if mask.max() > 1 else (
        np.asarray(mask) > 0
    ).astype(np.uint8) * 255
    contours, _ = cv2.findContours(binary, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
    if not contours:
        return None
    contour = max(contours, key=cv2.contourArea)
    if cv2.contourArea(contour) < min_area:
        return None

    # epsilon sweep for a convex quad (approxPolyDP fallback chain)
    peri = cv2.arcLength(contour, True)
    for eps_frac in (0.01, 0.02, 0.03, 0.05, 0.08):
        approx = cv2.approxPolyDP(contour, eps_frac * peri, True)
        if len(approx) == 4 and cv2.isContourConvex(approx):
            return order_corners(approx.reshape(4, 2))
    # fallback: min-area rotated rectangle
    rect = cv2.minAreaRect(contour)
    box = cv2.boxPoints(rect)
    return order_corners(box)


def process_dataset(
    dataset_root: str,
    splits: Tuple[str, ...] = ("train", "test"),
    output_name: str = "corner_annotations.json",
) -> Dict[str, Dict[str, list]]:
    """Derive corners for every mask and write corner_annotations.json in
    the reference's layout: {split: {image_filename: [[x,y]*4]}}."""
    import cv2

    annotations: Dict[str, Dict[str, list]] = {}
    skipped: List[str] = []
    for split in splits:
        mask_dir = os.path.join(dataset_root, split, "masks")
        img_dir = os.path.join(dataset_root, split, "images")
        if not os.path.isdir(mask_dir):
            continue
        annotations[split] = {}
        for fname in sorted(os.listdir(mask_dir)):
            if not fname.lower().endswith((".png", ".jpg")):
                continue
            mask = cv2.imread(os.path.join(mask_dir, fname), cv2.IMREAD_GRAYSCALE)
            if mask is None or mask.max() == 0:
                continue  # negatives carry no corner annotation
            corners = find_card_corners(mask)
            if corners is None:
                skipped.append(f"{split}/{fname}")
                continue
            stem = os.path.splitext(fname)[0]
            img_name = None
            for ext in (".jpg", ".jpeg", ".png"):
                if os.path.exists(os.path.join(img_dir, stem + ext)):
                    img_name = stem + ext
                    break
            if img_name is None:
                continue
            annotations[split][img_name] = corners.tolist()
    out_path = os.path.join(dataset_root, output_name)
    with open(out_path, "w") as f:
        json.dump(annotations, f)
    if skipped:
        print(f"[corners] {len(skipped)} masks without a clean quad skipped")
    return annotations


def create_yolo_annotations(
    dataset_root: str,
    output_root: str,
    annotations: Optional[Dict[str, Dict[str, list]]] = None,
    pad: float = 0.05,
) -> str:
    """Materialize the YOLO-pose directory layout + labels + data.yaml from
    corner annotations (*_yolo12n/dataset.py:175-295 contract: class 0,
    bbox from corners with 5% pad, 4 x (x, y, vis=2) keypoints,
    kpt_shape [4,3], flip_idx [1,0,3,2])."""
    import shutil

    import cv2

    if annotations is None:
        with open(os.path.join(dataset_root, "corner_annotations.json")) as f:
            annotations = json.load(f)

    for split, items in annotations.items():
        img_out = os.path.join(output_root, split, "images")
        lbl_out = os.path.join(output_root, split, "labels")
        os.makedirs(img_out, exist_ok=True)
        os.makedirs(lbl_out, exist_ok=True)
        for img_name, corners in items.items():
            src = os.path.join(dataset_root, split, "images", img_name)
            if not os.path.exists(src):
                continue
            img = cv2.imread(src)
            h, w = img.shape[:2]
            shutil.copy(src, os.path.join(img_out, img_name))
            c = np.asarray(corners, np.float32)
            mn, mx = c.min(axis=0), c.max(axis=0)
            wh = mx - mn
            mn = np.clip(mn - pad * wh, 0, [w, h])
            mx = np.clip(mx + pad * wh, 0, [w, h])
            cx, cy = (mn + mx) / 2
            bw, bh = mx - mn
            parts = [
                "0",
                f"{cx / w:.6f}", f"{cy / h:.6f}", f"{bw / w:.6f}", f"{bh / h:.6f}",
            ]
            for x, y in c:
                parts += [f"{x / w:.6f}", f"{y / h:.6f}", "2"]
            stem = os.path.splitext(img_name)[0]
            with open(os.path.join(lbl_out, stem + ".txt"), "w") as f:
                f.write(" ".join(parts) + "\n")

    yaml_path = os.path.join(output_root, "data.yaml")
    with open(yaml_path, "w") as f:
        f.write(
            "path: {root}\ntrain: train/images\nval: test/images\n"
            "nc: 1\nnames: ['card']\nkpt_shape: [4, 3]\n"
            "flip_idx: [1, 0, 3, 2]\n".format(root=os.path.abspath(output_root))
        )
    return yaml_path
