"""On-device augmentation suite, batched (counterpart of the JAX package's
``data/augment.py``).

Behavioural spec: the albumentations training pipeline at
train/dataset.py:100-187 of the reference (HFlip 0.5; Affine translate 25 %
/ scale 0.9-2 / rotate +-15 @ 0.8; Elastic alpha=50 sigma=5 @ 0.3;
GridDistortion 5 steps limit 0.1 @ 0.3; ColorJitter 0.2/0.2/0.2/0.1 @ 0.8;
RandomBrightnessContrast 0.2/0.2 @ 0.6; OneOf{GaussNoise std 0.1-0.2,
GaussianBlur} @ 0.5), as the JAX package re-designed it: every geometric
transform composes into one source-coordinate field, so the image is warped
once (bilinear; mask: nearest); the jitter runs in a fixed order with the hue
turned in the YIQ chroma plane.

The random part and the arithmetic are apart. ``draw_augment`` takes a
``torch.Generator`` and returns every value the JAX function draws, in the
role the JAX code gives it, per sample. The other functions are pure
functions of those draws, batched over B. Probabilities gate by
multiplication and ``torch.where``, never by a Python branch on a draw, so
nothing waits for the host.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from mtg_card_image_segmentation_tpu_torch.config import AugmentConfig
from mtg_card_image_segmentation_tpu_torch.data import warp as W

_RGB2YIQ = np.array([[0.299, 0.587, 0.114], [0.596, -0.274, -0.322],
                     [0.211, -0.523, 0.312]], np.float32)
# the exact inverse (the published yiq->rgb constants are rounded and would
# break the theta=0 identity by ~1e-3), made once
_YIQ2RGB = np.linalg.inv(_RGB2YIQ.astype(np.float64)).astype(np.float32)


class AugmentOut(NamedTuple):
    image: torch.Tensor  # (B, H, W, 3) float32 in [0, 1]
    mask: torch.Tensor  # (B, H, W) int32
    keypoints: Optional[torch.Tensor] = None  # (B, K, 2) xy pixels


class GeometryDraws(NamedTuple):
    do_flip: torch.Tensor  # (B,) bool
    do_affine: torch.Tensor  # (B,) bool
    translate: torch.Tensor  # (B, 2) uniform +-translate_percent, (y, x)
    scale: torch.Tensor  # (B,)
    angle_deg: torch.Tensor  # (B,) uniform +-rotate_limit_deg


class DisplacementDraws(NamedTuple):
    do_elastic: torch.Tensor  # (B,) bool
    noise_y: torch.Tensor  # (B, h, w) uniform [-1, 1)
    noise_x: torch.Tensor  # (B, h, w)
    do_grid: torch.Tensor  # (B,) bool
    grid_y: torch.Tensor  # (B, steps) uniform +-grid_distort_limit
    grid_x: torch.Tensor  # (B, steps)


class ColorDraws(NamedTuple):
    do_jitter: torch.Tensor  # (B,) bool
    brightness: torch.Tensor  # (B,) uniform +-brightness
    contrast: torch.Tensor  # (B,) uniform +-contrast
    saturation: torch.Tensor  # (B,) uniform +-saturation
    hue: torch.Tensor  # (B,) uniform +-hue
    do_bc: torch.Tensor  # (B,) bool
    bc_brightness: torch.Tensor  # (B,) uniform +-brightness
    bc_contrast: torch.Tensor  # (B,) uniform +-contrast
    do_noise_blur: torch.Tensor  # (B,) bool
    pick_noise: torch.Tensor  # (B,) bool
    noise_std: torch.Tensor  # (B,)
    noise: torch.Tensor  # (B, h, w, 3) standard normal
    blur_sigma: torch.Tensor  # (B,)


class AugmentDraws(NamedTuple):
    geometry: GeometryDraws
    displacement: Optional[DisplacementDraws]  # None on the keypoint path
    color: ColorDraws


def to_device(draws, device):
    """A draws tuple (nested, with None fields) with every tensor moved to
    ``device``."""
    if draws is None:
        return None
    if isinstance(draws, torch.Tensor):
        return draws.to(device)
    return type(draws)(*(to_device(d, device) for d in draws))


def _uniform(gen: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=gen.device)
    return lo + (hi - lo) * u


def _bernoulli(gen: torch.Generator, b: int, p: float) -> torch.Tensor:
    return torch.rand((b,), generator=gen, device=gen.device) < p


def draw_geometry(gen: torch.Generator, b: int, cfg: AugmentConfig) -> GeometryDraws:
    tp, lim = cfg.translate_percent, cfg.rotate_limit_deg
    return GeometryDraws(
        do_flip=_bernoulli(gen, b, cfg.hflip_prob),
        do_affine=_bernoulli(gen, b, cfg.affine_prob),
        translate=_uniform(gen, (b, 2), -tp, tp),
        scale=_uniform(gen, (b,), *cfg.scale_range),
        angle_deg=_uniform(gen, (b,), -lim, lim),
    )


def draw_displacement(gen: torch.Generator, b: int, h: int, w: int,
                      cfg: AugmentConfig) -> DisplacementDraws:
    lim, steps = cfg.grid_distort_limit, cfg.grid_num_steps
    return DisplacementDraws(
        do_elastic=_bernoulli(gen, b, cfg.elastic_prob),
        noise_y=_uniform(gen, (b, h, w), -1.0, 1.0),
        noise_x=_uniform(gen, (b, h, w), -1.0, 1.0),
        do_grid=_bernoulli(gen, b, cfg.grid_distort_prob),
        grid_y=_uniform(gen, (b, steps), -lim, lim),
        grid_x=_uniform(gen, (b, steps), -lim, lim),
    )


def draw_color(gen: torch.Generator, b: int, h: int, w: int, cfg: AugmentConfig) -> ColorDraws:
    return ColorDraws(
        do_jitter=_bernoulli(gen, b, cfg.color_jitter_prob),
        brightness=_uniform(gen, (b,), -cfg.brightness, cfg.brightness),
        contrast=_uniform(gen, (b,), -cfg.contrast, cfg.contrast),
        saturation=_uniform(gen, (b,), -cfg.saturation, cfg.saturation),
        hue=_uniform(gen, (b,), -cfg.hue, cfg.hue),
        do_bc=_bernoulli(gen, b, cfg.brightness_contrast_prob),
        bc_brightness=_uniform(gen, (b,), -cfg.brightness, cfg.brightness),
        bc_contrast=_uniform(gen, (b,), -cfg.contrast, cfg.contrast),
        do_noise_blur=_bernoulli(gen, b, cfg.noise_blur_prob),
        pick_noise=_bernoulli(gen, b, 0.5),
        noise_std=_uniform(gen, (b,), *cfg.noise_std_range),
        noise=torch.randn((b, h, w, 3), generator=gen, device=gen.device),
        blur_sigma=_uniform(gen, (b,), *cfg.blur_sigma_range),
    )


def draw_augment(gen: torch.Generator, b: int, h: int, w: int,
                 cfg: AugmentConfig = AugmentConfig(), keypoints: bool = False) -> AugmentDraws:
    """Every random value of ``augment_batch`` for ``b`` samples of (h, w),
    on ``gen``'s device. The keypoint path draws no displacement (elastic
    and grid distortion are off there)."""
    return AugmentDraws(
        draw_geometry(gen, b, cfg),
        None if keypoints else draw_displacement(gen, b, h, w, cfg),
        draw_color(gen, b, h, w, cfg),
    )


def geometry_matrix(g: GeometryDraws, h: int, w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward (B,3,3) matrices composing the hflip and the affine, each
    gated by its draw; returns (matrices, did_flip)."""
    b, dev = g.scale.shape[0], g.scale.device
    eye = torch.eye(3, device=dev).expand(b, 3, 3)
    flip_m = torch.tensor([[-1.0, 0.0, float(w - 1)], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]],
                          device=dev)
    flip = torch.where(g.do_flip[:, None, None], flip_m, eye)
    t = g.translate * torch.tensor([h, w], dtype=torch.float32, device=dev)
    angle = g.angle_deg * (math.pi / 180.0)
    affine = W.affine_matrix(t, g.scale, angle, ((h - 1) / 2.0, (w - 1) / 2.0))
    affine = torch.where(g.do_affine[:, None, None], affine, eye)
    return _matmul3(affine, flip), g.do_flip


def _matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3, 3) as products and sums: fp32 whatever the
    matmul precision switches say."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)`` for sorted (n,) ``xp`` and per-sample
    (B, n) ``fp``: linear between the nodes, clamped to the end values
    outside them."""
    n = xp.shape[0]
    i = torch.searchsorted(xp, x, right=True).clamp(1, n - 1)
    df = fp[:, i] - fp[:, i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    f = fp[:, i - 1] + (delta / dx) * df
    f = torch.where(x < xp[0], fp[:, :1], f)
    return torch.where(x > xp[-1], fp[:, -1:], f)


def displacement_fields(d: DisplacementDraws, h: int, w: int, cfg: AugmentConfig
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Elastic + grid-distortion source-coordinate offsets (dy, dx), each
    (B, h, w)."""
    dev = d.noise_y.device
    radius = max(1, int(3 * cfg.elastic_sigma))
    sigma = torch.full((d.noise_y.shape[0],), cfg.elastic_sigma, device=dev)
    do_el = d.do_elastic.float()[:, None, None]
    dy = W.gaussian_blur(d.noise_y[..., None], sigma, radius)[..., 0] * cfg.elastic_alpha * do_el
    dx = W.gaussian_blur(d.noise_x[..., None], sigma, radius)[..., 0] * cfg.elastic_alpha * do_el

    steps = cfg.grid_num_steps

    def axis_map(u, size):
        widths = (size / steps) * (1.0 + u)
        nodes_src = torch.cat([torch.zeros_like(widths[:, :1]), torch.cumsum(widths, 1)], 1)
        nodes_dst = torch.from_numpy(
            np.linspace(0.0, float(size), steps + 1).astype(np.float32)).to(dev)
        coords = torch.arange(size, dtype=torch.float32, device=dev)
        return _interp(coords, nodes_dst, nodes_src)

    do_gr = d.do_grid.float()[:, None]
    gy = axis_map(d.grid_y, h)  # (B, h)
    gx = axis_map(d.grid_x, w)  # (B, w)
    y_id = torch.arange(h, dtype=torch.float32, device=dev)
    x_id = torch.arange(w, dtype=torch.float32, device=dev)
    dy = dy + ((gy - y_id) * do_gr)[:, :, None]
    dx = dx + ((gx - x_id) * do_gr)[:, None, :]
    return dy, dx


def color_ops(c: ColorDraws, img: torch.Tensor) -> torch.Tensor:
    """ColorJitter (b, c, s, h in that order) + RandomBrightnessContrast +
    OneOf(noise, blur r=5), then a clip to [0, 1]. (B,H,W,3) float32."""
    dev = img.device

    def col(v):
        return v.float()[:, None, None, None]

    x = img
    do = col(c.do_jitter)
    x = x * (1.0 + do * col(c.brightness))
    gray = x.mean(-1, keepdim=True)
    gmean = gray.mean((1, 2, 3), keepdim=True)
    x = (x - gmean) * (1.0 + do * col(c.contrast)) + gmean
    x = gray + (x - gray) * (1.0 + do * col(c.saturation))
    # hue: rotation in the IQ chroma plane (YIQ), angle = hue * 2pi
    theta = c.do_jitter.float() * c.hue * 2.0 * math.pi
    cos_t, sin_t = torch.cos(theta), torch.sin(theta)
    zero, one = torch.zeros_like(theta), torch.ones_like(theta)
    rot = torch.stack([torch.stack([one, zero, zero], -1),
                       torch.stack([zero, cos_t, -sin_t], -1),
                       torch.stack([zero, sin_t, cos_t], -1)], -2)
    rgb2yiq = torch.from_numpy(_RGB2YIQ).to(dev)
    yiq2rgb = torch.from_numpy(_YIQ2RGB).to(dev)
    m = _matmul3(_matmul3(yiq2rgb, rot), rgb2yiq)  # (B,3,3)
    x = (x[..., None, :] * m[:, None, None]).sum(-1)  # x @ m.T per pixel

    do2 = col(c.do_bc)
    x = x * (1.0 + do2 * col(c.bc_contrast)) + do2 * col(c.bc_brightness)

    do3, pick = col(c.do_noise_blur), col(c.pick_noise)
    blurred = W.gaussian_blur(x, c.blur_sigma, radius=5)
    x = x + do3 * pick * (c.noise * col(c.noise_std))
    x = torch.where(do3 * (1.0 - pick) > 0.0, blurred, x)
    return x.clamp(0.0, 1.0)


def augment_batch(draws: AugmentDraws, images: torch.Tensor, masks: torch.Tensor,
                  cfg: AugmentConfig = AugmentConfig(),
                  keypoints: Optional[torch.Tensor] = None,
                  flip_idx: Optional[Sequence[int]] = None) -> AugmentOut:
    """Augment (B,H,W,3) [0,1] images + (B,H,W) masks (+ optional (B,K,2)
    xy keypoints) with ``draws``: one fused geometric warp, then the colour
    ops. With keypoints, elastic/grid are off and the points go through the
    forward matrix; ``flip_idx`` reorders them after a flip (TL,TR,BR,BL
    needs [1,0,3,2], the reference's kpt flip_idx, *_yolo12n/model.py:368)."""
    h, w = images.shape[1], images.shape[2]
    m_fwd, did_flip = geometry_matrix(draws.geometry, h, w)
    src_y, src_x = W.apply_homography_grid(W.invert_affine(m_fwd), h, w)
    new_kpts = None
    if keypoints is None:
        dy, dx = displacement_fields(draws.displacement, h, w, cfg)
        src_y = src_y + dy
        src_x = src_x + dx
    else:
        new_kpts = W.transform_points(m_fwd, keypoints)
        if flip_idx is not None:
            reordered = new_kpts[:, list(flip_idx)]
            new_kpts = torch.where(did_flip[:, None, None], reordered, new_kpts)
    img_out = W.warp_bilinear(images, src_y, src_x)
    mask_out = W.warp_nearest(masks.to(torch.int32), src_y, src_x)
    return AugmentOut(color_ops(draws.color, img_out), mask_out, new_kpts)


def augment_sample(draws: AugmentDraws, image: torch.Tensor, mask: torch.Tensor,
                   cfg: AugmentConfig = AugmentConfig(),
                   keypoints: Optional[torch.Tensor] = None,
                   flip_idx: Optional[Sequence[int]] = None) -> AugmentOut:
    """One (H,W,3) image + (H,W) mask (+ (K,2) keypoints) with the draws of
    a batch of one: :func:`augment_batch` without the leading dim."""
    out = augment_batch(draws, image[None], mask[None], cfg,
                        None if keypoints is None else keypoints[None], flip_idx)
    return AugmentOut(out.image[0], out.mask[0],
                      None if out.keypoints is None else out.keypoints[0])
