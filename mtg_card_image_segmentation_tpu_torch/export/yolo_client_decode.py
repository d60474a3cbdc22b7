"""Reference client-side decode for the exported YOLO12n-pose ONNX model
(copy of the JAX package's ``export/yolo_client_decode.py``).

STANDALONE FILE — numpy only, no package imports. export_yolo_torch.py
copies it verbatim into the deployment directory as ``decode_yolo.py``,
because the naive decode the raw graph suggests ("each keypoint at its
argmax kconf column") regresses to the corner-identity-swap failure mode:
on ~2% of (rotated) cards a corner channel double-picks another corner's
peak. This file mirrors the in-repo joint decode (models/yolo12_pose.py
top1_detection: joint top-3 greedy-NMS decode with collision penalty,
plausibility gate and canonical corner reordering); keep the two in sync
(tests/test_torch_yolo_export.py holds it to the JAX package's copy and to
top1_detection).

Usage:
    out = session.run(None, {"input": x})[0]      # (1, 17, A)
    box, score, corners = decode(out)
    # corners: (4, 3) [x, y, conf] in input pixels, TL TR BR BL order
"""

from __future__ import annotations

import numpy as np

KPT_COLLISION_PX = 24.0


NMS_CANDIDATES = 3

# quads below this area (input px^2) cannot be a card; keep in sync with
# models/yolo12_pose.py KPT_MIN_AREA_PX2
KPT_MIN_AREA_PX2 = 4.0 * KPT_COLLISION_PX ** 2

# models/yolo12_pose.py KPT_ORDER_BONUS (see its rationale: prefer
# assignments already in canonical TL/TR/BR/BL identity order — the
# channels are trained with those identities)
KPT_ORDER_BONUS = 0.25


def _canonicalize(kp: np.ndarray) -> np.ndarray:
    """Sort (K, 3) [x, y, conf] rows by angle around the centroid, starting
    at the smallest x+y — canonical TL TR BR BL image order."""
    ctr = kp[:, :2].mean(axis=0)
    ang = np.arctan2(kp[:, 1] - ctr[1], kp[:, 0] - ctr[0])
    kp = kp[np.argsort(ang)]
    start = int(np.argmin(kp[:, 0] + kp[:, 1]))
    return np.roll(kp, -start, axis=0)


def _quad_plausible(p: np.ndarray) -> bool:
    """(4, 2) canonical-order corners -> does the quad look like a card?
    Mirrors ops/heatmap.py quad_plausible: pairwise distinctness at the
    collision radius, clockwise-convex winding (y-down), card-sized area."""
    d2 = np.sum((p[:, None, :] - p[None, :, :]) ** 2, axis=-1)
    off = ~np.eye(len(p), dtype=bool)
    if d2[off].min() < KPT_COLLISION_PX ** 2:
        return False
    e = np.roll(p, -1, axis=0) - p
    en = np.roll(e, -1, axis=0)
    cross = e[:, 0] * en[:, 1] - e[:, 1] * en[:, 0]
    if not np.all(cross > 0):
        return False
    area = 0.5 * abs(
        np.sum(p[:, 0] * np.roll(p, -1, axis=0)[:, 1]
               - np.roll(p, -1, axis=0)[:, 0] * p[:, 1])
    )
    return bool(area >= KPT_MIN_AREA_PX2)


def decode(output0: np.ndarray, num_keypoints: int = 4):
    """(1, 4+nc+3K, A) raw model output -> (box(4,), score, corners(K, 3)).

    max_det=1 (one card per image): box from the best detection anchor;
    keypoints from a joint assignment over each corner channel's top-3
    SPATIALLY DISTINCT confidence peaks (greedy NMS — adjacent anchors of
    one peak are not alternatives; a channel's true corner is sometimes its
    3rd-ranked raw anchor behind two anchors of another corner's peak) with
    a collision penalty, then re-sorted into canonical image order
    (TL, TR, BR, BL).
    """
    out = np.asarray(output0)[0]  # (rows, A)
    k = num_keypoints
    boxes = out[:4]  # (4, A)
    scores = out[4:-3 * k]  # (nc, A)
    kpts = out[-3 * k:].reshape(k, 3, -1)  # (K, 3, A)

    conf = scores.max(axis=0)  # (A,)
    best_a = int(conf.argmax())
    box = boxes[:, best_a]
    score = float(conf[best_a])

    # top-n spatially distinct peaks per corner channel (greedy NMS on the
    # DECODED xy — distinct anchors can decode to the same point)
    n = NMS_CANDIDATES
    cand = np.empty((k, n, 3), np.float64)  # [x, y, conf]
    for ch in range(k):
        c = kpts[ch, 2, :].astype(np.float64).copy()
        xy = kpts[ch, :2, :].T  # (A, 2)
        for r in range(n):
            a = int(c.argmax())
            cand[ch, r] = (xy[a, 0], xy[a, 1], kpts[ch, 2, a])
            c[np.sum((xy - xy[a]) ** 2, axis=1) < KPT_COLLISION_PX ** 2] = -np.inf
    # enumerate all n^K rank assignments; penalize coincident corners and
    # gate on quad plausibility (the best *plausible* assignment wins; if
    # none is plausible the ordering among implausible ones is preserved —
    # mirrors models/yolo12_pose.py top1_detection)
    best_score, best_pick = -np.inf, None
    for c in range(n ** k):
        ranks, q = [], c
        for _ in range(k):
            ranks.append(q % n)
            q //= n
        pick = cand[np.arange(k), ranks]  # (K, 3)
        d2 = np.sum(
            (pick[None, :, :2] - pick[:, None, :2]) ** 2, axis=-1
        )
        collide = (d2 < KPT_COLLISION_PX ** 2) & ~np.eye(k, dtype=bool)
        # joint log-likelihood scoring (mirrors models/yolo12_pose.py: a
        # near-zero-conf corner must be near-fatal to a joint quad
        # hypothesis; a plain conf SUM let a garbage corner ride three
        # confident wrong-identity ones on the r5 frozen tail image)
        s = np.log(np.maximum(pick[:, 2], 1e-6)).sum() - 10.0 * collide.sum()
        can = _canonicalize(pick)
        if np.all(np.sum((can[:, :2] - pick[:, :2]) ** 2, axis=-1) < 1.0):
            s += KPT_ORDER_BONUS  # already in canonical identity order
        if not _quad_plausible(can[:, :2]):
            s -= 1e4
        if s > best_score:
            best_score, best_pick = s, pick
    kp = best_pick  # (K, 3)

    # canonical reorder: sort by angle around the centroid, start at the
    # point with the smallest x+y (top-left), i.e. TL TR BR BL
    return box, score, _canonicalize(kp)
