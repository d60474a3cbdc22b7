"""Keypoint heatmap ops (counterpart of the JAX package's
``ops/heatmap.py``): Gaussian target rendering, arg-max / sub-pixel /
soft-argmax decoding, thresholded peak extraction.

Heatmaps are NHWK (K = number of keypoints). Coordinates come back as xy
normalized to [0, 1] by (size - 1). Every arg-max takes the first of equal
maxima and every sort is stable, as in the reference, on the CPU and on the
card alike.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def gaussian_heatmaps(centers_xy: torch.Tensor, height: int, width: int,
                      sigma: float = 2.0) -> torch.Tensor:
    """(K, 2) xy centers (heatmap-pixel coords) -> (H, W, K) float32
    targets ``exp(-d^2 / (2 sigma^2))``. Centers with any negative
    coordinate (missing keypoint) render as zeros."""
    return gaussian_heatmaps_batch(centers_xy[None], height, width, sigma)[0]


def gaussian_heatmaps_batch(centers_xy: torch.Tensor, height: int, width: int,
                            sigma: float = 2.0) -> torch.Tensor:
    """(B, K, 2) -> (B, H, W, K), one broadcast over the batch."""
    c = centers_xy.float()
    dev = c.device
    x = torch.arange(width, device=dev, dtype=torch.float32)[None, None, :, None]
    y = torch.arange(height, device=dev, dtype=torch.float32)[None, :, None, None]
    cx = c[:, None, None, :, 0]
    cy = c[:, None, None, :, 1]
    d2 = (x - cx) ** 2 + (y - cy) ** 2
    hm = torch.exp(-d2 / (2.0 * sigma ** 2))
    valid = (c >= 0).all(dim=-1)[:, None, None, :]
    return torch.where(valid, hm, torch.zeros_like(hm))


def pixels_to_heatmap_coords(pixels_xy: torch.Tensor, image_hw: Tuple[int, int],
                             heatmap_hw: Tuple[int, int]) -> torch.Tensor:
    """Image-pixel xy -> heatmap-pixel xy (for Gaussian target rendering),
    by the (size-1) ratio. Negative (missing) coordinates become -1."""
    ih, iw = image_hw
    hh, hw = heatmap_hw
    scale = torch.tensor(np.asarray([(hw - 1) / (iw - 1), (hh - 1) / (ih - 1)], np.float32),
                         device=pixels_xy.device)
    scaled = pixels_xy * scale
    keep = (pixels_xy >= 0).all(dim=-1, keepdim=True)
    return torch.where(keep, scaled, torch.full_like(scaled, -1.0))


def _first_arg(x: torch.Tensor, dim: int, largest: bool = True) -> torch.Tensor:
    """Index of the first maximum (or minimum) along ``dim``: the tie rule
    of the reference's argmax/argmin, written out so that it does not depend
    on the backend's reduction order."""
    best = x.amax(dim, keepdim=True) if largest else x.amin(dim, keepdim=True)
    shape = [1] * x.dim()
    shape[dim] = x.shape[dim]
    pos = torch.arange(x.shape[dim], device=x.device).reshape(shape)
    return torch.where(x == best, pos, x.shape[dim]).amin(dim)


def _take(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``flat`` (B, HW, K) at flat positions ``idx`` (B, K) -> (B, K)."""
    return torch.gather(flat, 1, idx[:, None, :])[:, 0]


def decode_argmax(heatmaps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W, K) -> ((B, K, 2) xy in [0,1] by (size-1), (B, K) peak
    values): the integer arg-max decode."""
    b, h, w, k = heatmaps.shape
    flat = heatmaps.reshape(b, h * w, k)
    idx = _first_arg(flat, 1)
    vals = flat.amax(1)
    yy = (idx // w).float() / (h - 1)
    xx = (idx % w).float() / (w - 1)
    return torch.stack([xx, yy], dim=-1), vals


def _quadratic_subpixel(flat, py, px, vals, h, w):
    """Per-axis quadratic refinement at integer peaks (B, K): a parabola
    through (f(p-1), f(p), f(p+1)) peaks at p + (f(p+1)-f(p-1)) /
    (2*(2f(p)-f(p+1)-f(p-1))). Border peaks keep the integer decode."""

    def at(yy, xx):
        yy = yy.clamp(0, h - 1)
        xx = xx.clamp(0, w - 1)
        return _take(flat, yy * w + xx)

    def refine(minus, plus, interior):
        denom = 2.0 * vals - plus - minus
        safe = torch.where(denom == 0, torch.ones_like(denom), denom)
        off = torch.where(interior & (denom.abs() > 1e-6),
                          0.5 * (plus - minus) / safe, torch.zeros_like(denom))
        return off.clamp(-0.5, 0.5)

    off_x = refine(at(py, px - 1), at(py, px + 1), (px > 0) & (px < w - 1))
    off_y = refine(at(py - 1, px), at(py + 1, px), (py > 0) & (py < h - 1))
    xx01 = (px.float() + off_x) / (w - 1)
    yy01 = (py.float() + off_y) / (h - 1)
    return torch.stack([xx01, yy01], dim=-1)


def decode_argmax_subpixel(heatmaps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Arg-max decode + quadratic sub-pixel refinement. Returns ((B, K, 2)
    xy in [0,1] by (size-1), (B, K) peak values)."""
    b, h, w, k = heatmaps.shape
    flat = heatmaps.float().reshape(b, h * w, k)
    idx = _first_arg(flat, 1)
    vals = flat.amax(1)
    return _quadratic_subpixel(flat, idx // w, idx % w, vals, h, w), vals


def canonicalize_corners(kp: torch.Tensor) -> torch.Tensor:
    """Re-sort (B, K, C) corner rows (xy in the leading 2 of C) into
    canonical image order: by angle around the centroid, starting at the
    smallest x+y, i.e. TL, TR, BR, BL. Identity on ordered predictions."""
    ctr = kp[..., :2].mean(dim=1, keepdim=True)
    ang = torch.atan2(kp[..., 1] - ctr[..., 1], kp[..., 0] - ctr[..., 0])
    order = torch.argsort(ang, dim=1, stable=True)
    pts = torch.gather(kp, 1, order[..., None].expand_as(kp))
    start = _first_arg(pts[..., :2].sum(-1), 1, largest=False)  # (B,)
    n = kp.shape[1]
    roll = (start[:, None] + torch.arange(n, device=kp.device)[None, :]) % n
    return torch.gather(pts, 1, roll[..., None].expand_as(kp))


def decode_joint_nms(heatmaps: torch.Tensor, num_candidates: int = 3,
                     collision_px: float = 6.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Joint corner decode: per channel ``num_candidates`` spatially
    distinct peaks (greedy NMS, radius ``collision_px`` heatmap px), then
    the best of all n^K assignments by sum(conf) minus 10 per colliding
    pair, quadratic sub-pixel refinement of the chosen peaks, canonical
    reordering. Returns ((B, K, 2) xy in [0,1], (B, K) confidences)."""
    b, h, w, k = heatmaps.shape
    dev = heatmaps.device
    flat = heatmaps.float().reshape(b, h * w, k)
    ys = torch.arange(h, device=dev, dtype=torch.float32).repeat_interleave(w)
    xs = torch.arange(w, device=dev, dtype=torch.float32).repeat(h)

    masked = flat
    picks = []
    for _ in range(num_candidates):
        idx = _first_arg(masked, 1)  # (B, K)
        picks.append(idx)
        d2 = ((xs[None, :, None] - xs[idx][:, None, :]) ** 2
              + (ys[None, :, None] - ys[idx][:, None, :]) ** 2)  # (B, HW, K)
        masked = masked.masked_fill(d2 < collision_px ** 2, float("-inf"))
    idx3 = torch.stack(picks, dim=-1)  # (B, K, n)
    by_channel = flat.transpose(1, 2)  # (B, K, HW)
    conf3 = torch.gather(by_channel, 2, idx3)  # original confidences
    x3, y3 = xs[idx3], ys[idx3]

    # all assignments, digit 0 (corner 0's candidate) running fastest
    digits = []
    for c in range(num_candidates ** k):
        q, row = c, []
        for _ in range(k):
            row.append(q % num_candidates)
            q //= num_candidates
        digits.append(row)
    combos = torch.tensor(digits, device=dev)  # (n^K, K)
    kk = torch.arange(k, device=dev)[None, :]
    cx, cy, cconf = x3[:, kk, combos], y3[:, kk, combos], conf3[:, kk, combos]  # (B, n^K, K)
    d2c = ((cx[..., None, :] - cx[..., :, None]) ** 2
           + (cy[..., None, :] - cy[..., :, None]) ** 2)  # (B, n^K, K, K)
    collide = (d2c < collision_px ** 2) & ~torch.eye(k, dtype=torch.bool, device=dev)
    penalty = collide.sum(dim=(-1, -2)).float() * 10.0
    best = _first_arg(cconf.sum(-1) - penalty, 1)  # (B,)
    rank = combos[best]  # (B, K)
    idx_best = torch.gather(idx3, 2, rank[..., None])[..., 0]
    vals = torch.gather(by_channel, 2, idx_best[..., None])[..., 0]
    coords01 = _quadratic_subpixel(flat, idx_best // w, idx_best % w, vals, h, w)
    size = torch.tensor([w - 1, h - 1], device=dev, dtype=torch.float32)
    ordered = canonicalize_corners(torch.cat([coords01 * size, vals[..., None]], dim=-1))
    return ordered[..., :2] / size, ordered[..., 2]


def quad_plausible(corners_xy: torch.Tensor, min_dist: float = 4.0,
                   min_area: float = 16.0) -> torch.Tensor:
    """(B, 4, 2) corners (TL, TR, BR, BL) -> (B,) bool: pairwise distinct
    (no two within ``min_dist``), canonical winding (all cross products of
    consecutive edges positive, y down), and shoelace area >= ``min_area``."""
    p = corners_xy.float()
    d2 = ((p[:, :, None, :] - p[:, None, :, :]) ** 2).sum(-1)
    eye = torch.eye(p.shape[1], dtype=torch.bool, device=p.device)
    distinct = d2.masked_fill(eye, float("inf")).amin(dim=(1, 2)) >= min_dist ** 2
    nxt = torch.roll(p, -1, dims=1)
    e = nxt - p  # edges i -> i+1
    en = torch.roll(e, -1, dims=1)
    cross = e[..., 0] * en[..., 1] - e[..., 1] * en[..., 0]
    convex = (cross > 0).all(dim=1)
    area = 0.5 * (p[..., 0] * nxt[..., 1] - nxt[..., 0] * p[..., 1]).sum(1).abs()
    return distinct & convex & (area >= min_area)


def complete_dead_corner(coords: torch.Tensor, conf: torch.Tensor,
                         dead_conf: float = 0.2,
                         live_conf: float = 0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Parallelogram completion of a single dead corner channel:
    ``c[k] = c[k+1] + c[k-1] - c[k+2]`` where ``conf[k] < dead_conf``, every
    other corner clears ``live_conf`` and exactly one channel is dead.
    Returns (coords, fired (B, K) bool); confidences are left as they are."""
    comp = (torch.roll(coords, -1, dims=1) + torch.roll(coords, 1, dims=1)
            - torch.roll(coords, 2, dims=1))
    k = coords.shape[1]
    dead = conf < dead_conf
    eye = torch.eye(k, dtype=torch.bool, device=conf.device)
    others = conf[:, None, :].expand(-1, k, -1).masked_fill(eye[None], float("inf"))
    others_live = others.amin(-1) > live_conf
    fire = dead & others_live & (dead.sum(dim=1, keepdim=True) == 1)
    return torch.where(fire[..., None], comp, coords), fire


def decode_argmax_subpixel_gated(
    heatmaps: torch.Tensor, num_candidates: int = 3, collision_px: float = 6.0,
    dead_conf: float = 0.2, live_conf: float = 0.5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Independent sub-pixel decode with two per-image gated repairs: the
    dead-channel completion, then, for quadrilaterals that fail
    :func:`quad_plausible` (in heatmap pixels), the joint-NMS decode.
    Images that pass keep their independent decode bit for bit."""
    _, h, w, _ = heatmaps.shape
    coords01, vals = decode_argmax_subpixel(heatmaps)
    coords01, _ = complete_dead_corner(coords01, vals, dead_conf=dead_conf,
                                       live_conf=live_conf)
    size = torch.tensor([w - 1, h - 1], device=heatmaps.device, dtype=torch.float32)
    ok = quad_plausible(coords01 * size)
    jcoords01, jvals = decode_joint_nms(heatmaps, num_candidates=num_candidates,
                                        collision_px=collision_px)
    coords = torch.where(ok[:, None, None], coords01, jcoords01)
    conf = torch.where(ok[:, None], vals, jvals)
    return coords, conf


def decode_soft_argmax(heatmaps: torch.Tensor,
                       temperature: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable sub-pixel decode: softmax over the spatial grid,
    expectation of the coordinates. Returns ((B, K, 2) xy in [0,1], (B, K)
    peak values)."""
    b, h, w, k = heatmaps.shape
    flat = heatmaps.reshape(b, h * w, k).float()
    probs = torch.softmax(flat * temperature, dim=1)
    dev = heatmaps.device
    ys = (torch.arange(h, device=dev, dtype=torch.float32) / (h - 1)).repeat_interleave(w)
    xs = (torch.arange(w, device=dev, dtype=torch.float32) / (w - 1)).repeat(h)
    ex = torch.einsum("bpk,p->bk", probs, xs)
    ey = torch.einsum("bpk,p->bk", probs, ys)
    return torch.stack([ex, ey], dim=-1), flat.amax(1)


def extract_peaks(heatmaps: torch.Tensor, threshold: float = 0.3):
    """Inference-style peak extraction: sub-pixel arg-max decode + validity
    by confidence threshold (inference_test.py:221-255). Returns
    (coords01, confidences, valid)."""
    coords, vals = decode_argmax_subpixel(heatmaps)
    return coords, vals, vals >= threshold


def coords01_to_pixels(coords01: torch.Tensor, image_hw: Tuple[int, int]) -> torch.Tensor:
    """[0,1] normalized xy -> pixel xy of an (H, W) image, by (size-1)."""
    h, w = image_hw
    return coords01 * torch.tensor([w - 1, h - 1], device=coords01.device,
                                   dtype=torch.float32)
