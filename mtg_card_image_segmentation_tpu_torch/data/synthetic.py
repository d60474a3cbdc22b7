"""Procedural synthetic card renderer on the device, batched (counterpart
of the JAX package's ``data/synthetic.py``, the stand-in for the
reference's BlenderProc/Cycles generator, dataset_generator/
generate_synthetic.py).

A card is a rounded-rect SDF in card space (63x88 mm, 3 mm corners), placed
by a random perspective homography (4 jittered corners, a DLT solve per
sample); texture and background are procedural functions of coordinates,
lighting a low-frequency field + vignette; ~9 % of samples are card-free
negatives (the reference's 800/8800 background negatives). With an
``AssetBank``, real card scans, photo backgrounds and HDRI environments
composite in through the same homography.

Random draws and arithmetic are apart: ``draw_scene`` takes a
``torch.Generator`` and returns every value the JAX renderer draws, per
sample; ``render_scene`` is a pure function of those draws. Augmentation
geometry composes into the render coordinates
(``render_augmented_scene``): every procedural layer is evaluated at the
inverse-augmentation source coordinates, so there is no render-then-warp.

Corners come out in image-space clockwise-from-top-left order TL, TR, BR, BL
(``canonicalize_corners``), -1 where there is no card.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from mtg_card_image_segmentation_tpu_torch.config import AugmentConfig
from mtg_card_image_segmentation_tpu_torch.data import warp as W
from mtg_card_image_segmentation_tpu_torch.data.augment import (
    AugmentDraws,
    color_ops,
    displacement_fields,
    draw_augment,
    geometry_matrix,
)

# physical card geometry (mm), generate_synthetic.py:63-67 of the reference
CARD_W_MM = 63.0
CARD_H_MM = 88.0
CORNER_RADIUS_MM = 3.0
NEGATIVE_PROB = 0.09  # ~800/8800 background-only samples


class SyntheticSample(NamedTuple):
    image: torch.Tensor  # (B, H, W, 3) float32 in [0, 1]
    mask: torch.Tensor  # (B, H, W) int32 {0, 1}
    corners: torch.Tensor  # (B, 4, 2) xy pixels, TL TR BR BL; -1 when no card
    has_card: torch.Tensor  # (B,) bool


class AssetBank(NamedTuple):
    """Device-resident real-asset library: card scans as textures, photos
    as backgrounds, equirect HDRI environments tone-mapped to [0, 1], and
    their blurred mean-1 illumination fields. An empty kind (leading dim
    0) falls back to the procedural layer."""

    textures: torch.Tensor  # (Nt, Th, Tw, 3) float32 [0,1], card aspect H:W = 88:63
    backgrounds: torch.Tensor  # (Nb, Bh, Bw, 3) float32 [0,1]
    hdris: torch.Tensor = torch.zeros((0, 64, 128, 3))
    hdri_light: torch.Tensor = torch.zeros((0, 16, 32, 3))


def load_asset_bank(
    texture_dir: Optional[str],
    background_dir: Optional[str] = None,
    tex_hw: Tuple[int, int] = (352, 256),
    bg_hw: Tuple[int, int] = (480, 640),
    max_assets: int = 512,
    hdri_dir: Optional[str] = None,
    hdri_hw: Tuple[int, int] = (64, 128),
    device=None,
) -> AssetBank:
    """Decode card scans / background photos / HDRI maps on the host (cv2,
    INTER_AREA resize; .hdr/.exr Reinhard tone-mapped) into a bank on
    ``device`` (default: the card). Reads every jpg/png (and .hdr/.exr for
    ``hdri_dir``) under each directory, recursively; any directory may be
    empty or None."""
    import cv2

    from mtg_card_image_segmentation_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(device)

    def load_dir(d, hw, hdr=False):
        if not d or not os.path.isdir(d):
            return np.zeros((0, hw[0], hw[1], 3), np.float32)
        exts = (".jpg", ".jpeg", ".png", ".hdr", ".exr") if hdr else (".jpg", ".jpeg", ".png")
        paths = []
        for root, _, files in os.walk(d):
            for f in sorted(files):
                if f.lower().endswith(exts):
                    paths.append(os.path.join(root, f))
        out = []
        for p in paths[:max_assets]:
            flags = cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR if hdr else cv2.IMREAD_COLOR
            img = cv2.imread(p, flags)
            if img is None:
                continue
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32)
            if p.lower().endswith((".hdr", ".exr")):
                img = img / (1.0 + img)  # Reinhard: radiance -> [0,1)
            else:
                img = img / 255.0
            img = cv2.resize(img, (hw[1], hw[0]), interpolation=cv2.INTER_AREA)
            out.append(np.clip(img, 0.0, 1.0))
        if not out:
            return np.zeros((0, hw[0], hw[1], 3), np.float32)
        return np.stack(out)

    hdris = load_dir(hdri_dir, hdri_hw, hdr=True)
    if hdris.shape[0]:
        # illumination field: blur to low frequency, normalize mean to 1.0
        light = np.stack([
            cv2.GaussianBlur(cv2.resize(im, (32, 16), interpolation=cv2.INTER_AREA), (5, 5), 2.0)
            for im in hdris
        ])
        light = light / np.maximum(light.mean(axis=(1, 2, 3), keepdims=True), 1e-3)
    else:
        light = np.zeros((0, 16, 32, 3), np.float32)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    return AssetBank(put(load_dir(texture_dir, tex_hw)), put(load_dir(background_dir, bg_hw)),
                     put(hdris), put(light))


class SceneDraws(NamedTuple):
    """Every random value of one batch of scenes, per sample (leading B)."""

    # background (_background_at)
    bg_c0: torch.Tensor  # (B, 3) uniform [0, 1)
    bg_c1: torch.Tensor  # (B, 3)
    bg_angle: torch.Tensor  # (B,) uniform [0, 2pi)
    bg_freq: torch.Tensor  # (B, 4) uniform [1, 8)
    bg_noise: torch.Tensor  # (B, h, w) uniform +-0.04
    # procedural texture (_card_texture)
    border_col: torch.Tensor  # (B, 3) [0, 0.15)
    frame_col: torch.Tensor  # (B, 3) [0.2, 0.9)
    art_col: torch.Tensor  # (B, 3) [0.1, 0.9)
    art_col2: torch.Tensor  # (B, 3) [0.1, 0.9)
    text_col: torch.Tensor  # (B, 3) [0.7, 0.95)
    tex_f: torch.Tensor  # (B, 4) f1, f2, p1, p2 uniform [0, 1)
    # placement
    scale: torch.Tensor  # (B,) [0.35, 0.95), or [0.35, 0.72) in frame
    angle: torch.Tensor  # (B,) [0, 2pi)
    pos: torch.Tensor  # (B, 2) x, y offsets, uniform +-0.2
    persp: torch.Tensor  # (B, 4, 2) corner jitter, uniform +-0.06
    has_card: torch.Tensor  # (B,) bool, not bernoulli(negative_prob)
    # lighting
    light_pos: torch.Tensor  # (B, 2) lx, ly uniform [0, 1)
    exposure: torch.Tensor  # (B,) [0.85, 1.15)
    # asset bank (None where the bank has none of that kind)
    bg_index: Optional[torch.Tensor] = None  # (B,) long
    use_real_bg: Optional[torch.Tensor] = None  # (B,) bool, p = real_prob
    hdri_index: Optional[torch.Tensor] = None
    hdri_rot: Optional[torch.Tensor] = None  # (B,) [0, 1)
    use_hdri_bg: Optional[torch.Tensor] = None  # p = real_prob (/2 with photos)
    tex_index: Optional[torch.Tensor] = None
    use_real_tex: Optional[torch.Tensor] = None  # p = real_prob
    light_index: Optional[torch.Tensor] = None
    light_rot: Optional[torch.Tensor] = None  # (B,) [0, 1)
    light_strength: Optional[torch.Tensor] = None  # (B,) [0.8, 1.5)


def _u(gen, shape, lo=0.0, hi=1.0):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=gen.device)


def _p(gen, b, p):
    return torch.rand((b,), generator=gen, device=gen.device) < p


def _randint(gen, b, n):
    return torch.randint(0, n, (b,), generator=gen, device=gen.device)


def draw_scene(gen: torch.Generator, b: int, h: int, w: int,
               negative_prob: float = NEGATIVE_PROB, assets: Optional[AssetBank] = None,
               real_prob: float = 0.7, keep_in_frame: bool = False) -> SceneDraws:
    """Every random value of ``render_scene`` for ``b`` scenes of (h, w), on
    ``gen``'s device."""
    two_pi = 2 * math.pi
    d = dict(
        bg_c0=_u(gen, (b, 3)), bg_c1=_u(gen, (b, 3)), bg_angle=_u(gen, (b,), 0.0, two_pi),
        bg_freq=_u(gen, (b, 4), 1.0, 8.0), bg_noise=_u(gen, (b, h, w), -0.04, 0.04),
        border_col=_u(gen, (b, 3), 0.0, 0.15), frame_col=_u(gen, (b, 3), 0.2, 0.9),
        art_col=_u(gen, (b, 3), 0.1, 0.9), art_col2=_u(gen, (b, 3), 0.1, 0.9),
        text_col=_u(gen, (b, 3), 0.7, 0.95), tex_f=_u(gen, (b, 4)),
        scale=_u(gen, (b,), 0.35, 0.72 if keep_in_frame else 0.95),
        angle=_u(gen, (b,), 0.0, two_pi), pos=_u(gen, (b, 2), -0.2, 0.2),
        persp=_u(gen, (b, 4, 2), -0.06, 0.06),
        has_card=~_p(gen, b, negative_prob),
        light_pos=_u(gen, (b, 2)), exposure=_u(gen, (b,), 0.85, 1.15),
    )
    if assets is not None:
        nb, ne, nt = (assets.backgrounds.shape[0], assets.hdris.shape[0],
                      assets.textures.shape[0])
        if nb:
            d.update(bg_index=_randint(gen, b, nb), use_real_bg=_p(gen, b, real_prob))
        if ne:
            d.update(hdri_index=_randint(gen, b, ne), hdri_rot=_u(gen, (b,)),
                     use_hdri_bg=_p(gen, b, real_prob * (0.5 if nb else 1.0)))
        if nt:
            d.update(tex_index=_randint(gen, b, nt), use_real_tex=_p(gen, b, real_prob))
        if assets.hdri_light.shape[0]:
            d.update(light_index=_randint(gen, b, assets.hdri_light.shape[0]),
                     light_rot=_u(gen, (b,)), light_strength=_u(gen, (b,), 0.8, 1.5))
    return SceneDraws(**d)


def rounded_rect_sdf(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Signed distance (mm) to the rounded card rectangle; card-space uv in
    [0,1]^2."""
    px = u * CARD_W_MM - CARD_W_MM / 2.0
    py = v * CARD_H_MM - CARD_H_MM / 2.0
    qx = px.abs() - (CARD_W_MM / 2.0 - CORNER_RADIUS_MM)
    qy = py.abs() - (CARD_H_MM / 2.0 - CORNER_RADIUS_MM)
    outside = torch.sqrt(qx.clamp(min=0.0) ** 2 + qy.clamp(min=0.0) ** 2)
    inside = torch.maximum(qx, qy).clamp(max=0.0)
    return outside + inside - CORNER_RADIUS_MM


def band(x: torch.Tensor, lo: float, hi: float, soft: float = 0.01) -> torch.Tensor:
    """Smooth indicator of lo <= x <= hi."""
    return torch.sigmoid((x - lo) / soft) * torch.sigmoid((hi - x) / soft)


def _per_sample(t: torch.Tensor) -> torch.Tensor:
    """(B, ...) draws broadcast against (B, h, w, ...) maps."""
    return t.reshape(t.shape[0], 1, 1, *t.shape[1:])


def card_texture(d: SceneDraws, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Procedural MTG-like face at card-space (B,h,w) uv: border frame,
    title band, art box, text box, mottled art. (B,h,w,3) in [0, 1]."""
    f1, f2, p1, p2 = (_per_sample(d.tex_f[:, i]) for i in range(4))
    inner = band(u, 0.045, 0.955) * band(v, 0.035, 0.965)
    art = band(u, 0.08, 0.92) * band(v, 0.11, 0.54)
    text = band(u, 0.08, 0.92) * band(v, 0.60, 0.92)
    title = band(u, 0.08, 0.92) * band(v, 0.045, 0.095)
    wave = 0.5 + 0.5 * torch.sin(
        (6.0 + 10.0 * f1) * u + (6.0 + 10.0 * f2) * v + p1 * 6.28
    ) * torch.sin((4.0 + 8.0 * f2) * v - (3.0 + 6.0 * f1) * u + p2 * 6.28)
    wave = wave[..., None]
    art_tex = _per_sample(d.art_col) * wave + _per_sample(d.art_col2) * (1.0 - wave)
    inner, art, text, title = (t[..., None] for t in (inner, art, text, title))
    frame = _per_sample(d.frame_col)
    color = _per_sample(d.border_col)
    color = color * (1 - inner) + frame * inner
    color = color * (1 - art) + art_tex * art
    color = color * (1 - text) + _per_sample(d.text_col) * text
    color = color * (1 - title) + (frame * 0.6) * title
    # faint text lines in the text box
    lines = 0.5 + 0.5 * torch.sin(v * 300.0)
    color = color - 0.12 * (text * (lines > 0.6)[..., None])
    return color.clamp(0.0, 1.0)


def background_at(d: SceneDraws, y: torch.Tensor, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Random gradient + sinusoidal mottling + noise at (B,h,w) coordinate
    maps (y, x), so augmentation geometry composes into the render."""
    ang = _per_sample(d.bg_angle)
    cos, sin = torch.cos(ang), torch.sin(ang)
    t = (x / w) * cos + (y / h) * sin
    # normalization bounds of the un-warped field (t over [0,1]^2): the
    # min/max of a linear field over the unit square
    t_lo = cos.clamp(max=0.0) + sin.clamp(max=0.0)
    t_hi = cos.clamp(min=0.0) + sin.clamp(min=0.0)
    t = ((t - t_lo) / (t_hi - t_lo + 1e-8))[..., None]
    grad = _per_sample(d.bg_c0) * t + _per_sample(d.bg_c1) * (1.0 - t)
    f = [_per_sample(d.bg_freq[:, i]) for i in range(4)]
    mottle = 0.5 + 0.25 * torch.sin(f[0] * x / w * 6.28 + f[1]) * torch.sin(
        f[2] * y / h * 6.28 + f[3])
    return (grad * mottle[..., None] + d.bg_noise[..., None]).clamp(0.0, 1.0)


def render_scene(d: SceneDraws, h: int, w: int, src_y: Optional[torch.Tensor] = None,
                 src_x: Optional[torch.Tensor] = None, assets: Optional[AssetBank] = None,
                 keep_in_frame: bool = False) -> SyntheticSample:
    """Render the scenes of ``d`` at (h, w). When ``src_y/src_x`` (B,h,w)
    are given (augmentation-composed source coordinates), every layer is
    evaluated at those coordinates: the same as rendering then
    inverse-warping, with a gather only for real-asset pixels. The corners
    returned are in render space."""
    b, dev = d.scale.shape[0], d.scale.device
    if src_y is None:
        gy, gx = W.identity_grid(h, w, dev)
        src_y, src_x = gy.expand(b, h, w), gx.expand(b, h, w)
    background = background_at(d, src_y, src_x, h, w)

    if assets is not None and assets.backgrounds.shape[0] > 0:
        # real photo background sampled at the (possibly augmented) source
        # coordinates: the gather is the price of real pixels
        bh, bw = assets.backgrounds.shape[1], assets.backgrounds.shape[2]
        bg_real = W.warp_bilinear(assets.backgrounds, src_y * ((bh - 1.0) / max(h - 1, 1)),
                                  src_x * ((bw - 1.0) / max(w - 1, 1)), d.bg_index)
        background = torch.where(d.use_real_bg[:, None, None, None], bg_real, background)

    if assets is not None and assets.hdris.shape[0] > 0:
        # HDRI environment as background: equirect with a random horizontal
        # rotation (the reference's random world rotation), wrapping in x
        eh, ew = assets.hdris.shape[1], assets.hdris.shape[2]
        ex = torch.remainder(src_x / max(w - 1, 1) * 0.5 + _per_sample(d.hdri_rot), 1.0) * (ew - 1.0)
        ey = (src_y / max(h - 1, 1)).clamp(0.0, 1.0) * (eh - 1.0)
        bg_hdri = W.warp_bilinear(assets.hdris, ey, ex, d.hdri_index)
        background = torch.where(d.use_hdri_bg[:, None, None, None], bg_hdri, background)

    # card placement: rect corners -> rotate -> translate -> perspective
    # jitter; keep_in_frame caps the scale (drawn) and shifts the quad
    card_h_px = d.scale * min(h, w)
    card_w_px = card_h_px * (CARD_W_MM / CARD_H_MM)
    cx = w / 2.0 + d.pos[:, 0] * w
    cy = h / 2.0 + d.pos[:, 1] * h
    half_x = torch.tensor([-0.5, 0.5, 0.5, -0.5], device=dev)
    half_y = torch.tensor([-0.5, -0.5, 0.5, 0.5], device=dev)
    bx, by = card_w_px[:, None] * half_x, card_h_px[:, None] * half_y  # TL TR BR BL, centered
    cos, sin = torch.cos(d.angle)[:, None], torch.sin(d.angle)[:, None]
    corners = torch.stack([bx * cos - by * sin + cx[:, None],
                           bx * sin + by * cos + cy[:, None]], -1)
    size = torch.stack([card_w_px, card_h_px], -1)[:, None]
    corners = corners + d.persp * size

    if keep_in_frame:
        # translate the quad fully inside the frame (2 px margin)
        margin = 2.0
        lim = torch.tensor([w - 1.0, h - 1.0], device=dev)
        shift = (margin - corners.amin(1)).clamp(min=0.0) - (
            corners.amax(1) - (lim - margin)).clamp(min=0.0)
        corners = corners + shift[:, None]

    # homography: image corners -> card uv unit square, for sampling
    src_uv = torch.tensor([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]],
                          device=dev).expand(b, 4, 2)
    h_inv = W.homography_from_points(corners, src_uv)
    y, x = src_y, src_x
    uv = W.transform_points(h_inv, torch.stack([x, y], -1).reshape(b, -1, 2))
    u, v = uv[..., 0].reshape(b, h, w), uv[..., 1].reshape(b, h, w)

    # anti-aliased coverage: SDF in mm -> pixels
    mm_per_px = CARD_H_MM / card_h_px.clamp(min=1.0)
    sdf_px = rounded_rect_sdf(u, v) / _per_sample(mm_per_px)
    alpha = (0.5 - sdf_px).clamp(0.0, 1.0) * _per_sample(d.has_card.float())

    card_rgb = card_texture(d, u, v)
    if assets is not None and assets.textures.shape[0] > 0:
        # real card scan sampled at card-space uv through the same homography
        th, tw = assets.textures.shape[1], assets.textures.shape[2]
        tex_real = W.warp_bilinear(assets.textures, v.clamp(0.0, 1.0) * (th - 1.0),
                                   u.clamp(0.0, 1.0) * (tw - 1.0), d.tex_index)
        card_rgb = torch.where(d.use_real_tex[:, None, None, None], tex_real, card_rgb)
    a = alpha[..., None]
    img = background * (1.0 - a) + card_rgb * a

    # illumination: low-frequency light field + vignette + exposure
    lx, ly = _per_sample(d.light_pos[:, 0]), _per_sample(d.light_pos[:, 1])
    d2 = ((x / w) - lx) ** 2 + ((y / h) - ly) ** 2
    light = (1.15 - 0.5 * torch.sqrt(d2))[..., None]
    if assets is not None and assets.hdri_light.shape[0] > 0:
        # HDRI world illumination at strength 0.8-1.5 with a random
        # rotation, blended toward neutral so strength scales contrast too
        lh, lw = assets.hdri_light.shape[1], assets.hdri_light.shape[2]
        gx = torch.remainder(x / max(w - 1, 1) * 0.5 + _per_sample(d.light_rot), 1.0) * (lw - 1.0)
        gy = (y / max(h - 1, 1)).clamp(0.0, 1.0) * (lh - 1.0)
        hdr_field = W.warp_bilinear(assets.hdri_light, gy, gx, d.light_index)
        light = _per_sample(d.light_strength)[..., None] * (0.5 + 0.5 * hdr_field)
    img = (img * light * _per_sample(d.exposure)[..., None]).clamp(0.0, 1.0)

    mask = (alpha > 0.5).to(torch.int32)
    corners = canonicalize_corners(corners)
    corners = torch.where(d.has_card[:, None, None], corners, -torch.ones_like(corners))
    return SyntheticSample(img, mask, corners, d.has_card)


def canonicalize_corners(corners: torch.Tensor) -> torch.Tensor:
    """Reorder (B,4,2) xy quads to image-space clockwise-from-top-left (TL,
    TR, BR, BL), the reference's corner-annotation contract
    (train/preprocess_masks.py:196-223). Ascending atan2 around the centroid
    is clockwise when y points down; the cycle is rolled so min(x+y)
    comes first."""
    c = corners.mean(1, keepdim=True)
    ang = torch.atan2(corners[..., 1] - c[..., 1], corners[..., 0] - c[..., 0])
    order = torch.argsort(ang, dim=1, stable=True)
    pts = torch.gather(corners, 1, order[..., None].expand(-1, -1, 2))
    start = torch.argmin(pts.sum(-1), dim=1)
    roll = (start[:, None] + torch.arange(4, device=corners.device)) % 4
    return torch.gather(pts, 1, roll[..., None].expand(-1, -1, 2))


def synthetic_batch(gen: torch.Generator, batch: int, h: int = 320, w: int = 240,
                    negative_prob: float = NEGATIVE_PROB, assets: Optional[AssetBank] = None,
                    real_prob: float = 0.7, keep_in_frame: bool = False) -> SyntheticSample:
    """``batch`` scenes of (h, w) drawn from ``gen`` and rendered on its
    device."""
    d = draw_scene(gen, batch, h, w, negative_prob, assets, real_prob, keep_in_frame)
    return render_scene(d, h, w, None, None, assets, keep_in_frame)


def synthetic_sample(gen: torch.Generator, h: int = 320, w: int = 240,
                     negative_prob: float = NEGATIVE_PROB, assets: Optional[AssetBank] = None,
                     real_prob: float = 0.7, keep_in_frame: bool = False) -> SyntheticSample:
    """One scene: :func:`synthetic_batch` of one without the leading dim."""
    s = synthetic_batch(gen, 1, h, w, negative_prob, assets, real_prob, keep_in_frame)
    return SyntheticSample(*(t[0] for t in s))


class AugmentedSceneDraws(NamedTuple):
    scene: SceneDraws
    augment: AugmentDraws  # its displacement is None without elastic/grid


def draw_augmented_scene(gen: torch.Generator, b: int, h: int, w: int, negative_prob: float,
                         aug_cfg: AugmentConfig, with_displacement: bool = True,
                         assets: Optional[AssetBank] = None, real_prob: float = 0.7,
                         keep_in_frame: bool = False) -> AugmentedSceneDraws:
    return AugmentedSceneDraws(
        draw_scene(gen, b, h, w, negative_prob, assets, real_prob, keep_in_frame),
        draw_augment(gen, b, h, w, aug_cfg, keypoints=not with_displacement))


def render_augmented_scene(d: AugmentedSceneDraws, h: int, w: int, aug_cfg: AugmentConfig,
                           assets: Optional[AssetBank] = None,
                           keep_in_frame: bool = False) -> SyntheticSample:
    """The scenes with the augmentation suite's geometry composed into the
    render coordinates (hflip/affine, and elastic/grid unless ``d`` has no
    displacement draws, the keypoint-aware path): zero border outside the
    source frame (cv2 BORDER_CONSTANT), corners through the forward matrix
    and re-canonicalised (a flip reverses the winding, a turn can move
    another corner to the top left), then the colour ops."""
    m_fwd, _ = geometry_matrix(d.augment.geometry, h, w)
    src_y, src_x = W.apply_homography_grid(W.invert_affine(m_fwd), h, w)
    if d.augment.displacement is not None:
        dy, dx = displacement_fields(d.augment.displacement, h, w, aug_cfg)
        src_y = src_y + dy
        src_x = src_x + dx
    sample = render_scene(d.scene, h, w, src_y, src_x, assets, keep_in_frame)
    valid = (src_y >= 0.0) & (src_y <= h - 1.0) & (src_x >= 0.0) & (src_x <= w - 1.0)
    image = torch.where(valid[..., None], sample.image, 0.0)
    mask = torch.where(valid, sample.mask, torch.zeros((), dtype=torch.int32, device=valid.device))
    corners = canonicalize_corners(W.transform_points(m_fwd, sample.corners))
    corners = torch.where(sample.has_card[:, None, None], corners, -torch.ones_like(corners))
    return SyntheticSample(color_ops(d.augment.color, image), mask, corners, sample.has_card)


def synthetic_augmented_batch(gen: torch.Generator, batch: int, h: int, w: int,
                              negative_prob: float, aug_cfg: AugmentConfig,
                              with_displacement: bool = True, assets: Optional[AssetBank] = None,
                              real_prob: float = 0.7, keep_in_frame: bool = False
                              ) -> SyntheticSample:
    """``batch`` augmented scenes drawn from ``gen`` and rendered on its
    device (the JAX function's ``flip_idx`` is accepted there and unused;
    the corners are re-canonicalised instead)."""
    d = draw_augmented_scene(gen, batch, h, w, negative_prob, aug_cfg, with_displacement,
                             assets, real_prob, keep_in_frame)
    return render_augmented_scene(d, h, w, aug_cfg, assets, keep_in_frame)
