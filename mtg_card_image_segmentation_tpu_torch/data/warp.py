"""Inverse-warp samplers, batched: the geometric core of the augmentation
suite and of the synthetic renderer (counterpart of the JAX package's
``data/warp.py``, which ``vmap``s one sample at a time).

Images are NHWC, coordinate maps ``(B, h, w)``, matrices ``(B, 3, 3)`` in the
(x, y, 1) convention. Every transform reduces to "build a source-coordinate
field, warp"; samples outside the source are 0 (cv2 BORDER_CONSTANT). Both
warps are explicit gathers with the reference's validity windows, which
``grid_sample`` does not reproduce: bilinear reads nothing outside
``[0, h-1] x [0, w-1]``, nearest rounds half to even (as ``jnp.round`` does)
inside ``[-0.5, h-0.5)``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _gather(img: torch.Tensor, index: torch.Tensor, iy: torch.Tensor,
            ix: torch.Tensor) -> torch.Tensor:
    """``img[index[b], iy, ix]`` with the indices clamped into the image
    (validity is the caller's mask): (N,H,W,C) -> (B,h,w,C)."""
    h, w = img.shape[1], img.shape[2]
    return img[index[:, None, None], iy.clamp(0, h - 1), ix.clamp(0, w - 1)]


def _index(src_y: torch.Tensor, index: Optional[torch.Tensor]) -> torch.Tensor:
    if index is None:
        return torch.arange(src_y.shape[0], device=src_y.device)
    return index


def warp_bilinear(img: torch.Tensor, src_y: torch.Tensor, src_x: torch.Tensor,
                  index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sample (N,H,W,C) ``img`` at float source coordinates (B,h,w),
    bilinear, zero outside; float32 (B,h,w,C). Sample ``b`` reads image
    ``index[b]`` (default ``b``), so a bank of images is sampled without
    copying one per sample."""
    img = img.float()
    index = _index(src_y, index)
    y0f, x0f = torch.floor(src_y), torch.floor(src_x)
    y0, x0 = y0f.long(), x0f.long()
    wy = (src_y - y0f)[..., None]
    wx = (src_x - x0f)[..., None]
    v00 = _gather(img, index, y0, x0)
    v01 = _gather(img, index, y0, x0 + 1)
    v10 = _gather(img, index, y0 + 1, x0)
    v11 = _gather(img, index, y0 + 1, x0 + 1)
    top = v00 + (v01 - v00) * wx
    bot = v10 + (v11 - v10) * wx
    out = top + (bot - top) * wy
    h, w = img.shape[1], img.shape[2]
    valid = (src_y >= 0.0) & (src_y <= h - 1.0) & (src_x >= 0.0) & (src_x <= w - 1.0)
    return torch.where(valid[..., None], out, 0.0)


def warp_nearest(img: torch.Tensor, src_y: torch.Tensor, src_x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour warp of (B,H,W[,C]) masks/labels, zero outside;
    keeps the dtype."""
    squeeze = img.dim() == 3
    if squeeze:
        img = img[..., None]
    iy = torch.round(src_y).long()
    ix = torch.round(src_x).long()
    out = _gather(img, _index(src_y, None), iy, ix)
    h, w = img.shape[1], img.shape[2]
    valid = (src_y >= -0.5) & (src_y < h - 0.5) & (src_x >= -0.5) & (src_x < w - 0.5)
    out = torch.where(valid[..., None], out, torch.zeros((), dtype=out.dtype, device=out.device))
    return out[..., 0] if squeeze else out


def identity_grid(h: int, w: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, x) float32 coordinate maps of shape (h, w)."""
    y = torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w)
    x = torch.arange(w, dtype=torch.float32, device=device)[None, :].expand(h, w)
    return y, x


def apply_homography_grid(matrix: torch.Tensor, h: int, w: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Source coordinates (B,h,w) for inverse-warping by (B,3,3) ``matrix``,
    which maps *output* (x, y, 1) to *source* (x', y', w')."""
    y, x = identity_grid(h, w, matrix.device)
    m = matrix[:, :, :, None, None]
    sx = m[:, 0, 0] * x + m[:, 0, 1] * y + m[:, 0, 2]
    sy = m[:, 1, 0] * x + m[:, 1, 1] * y + m[:, 1, 2]
    sw = m[:, 2, 0] * x + m[:, 2, 1] * y + m[:, 2, 2]
    sw = torch.where(sw.abs() < 1e-8, 1e-8, sw)
    return sy / sw, sx / sw


def affine_matrix(translate_yx: torch.Tensor, scale: torch.Tensor, angle_rad: torch.Tensor,
                  center_yx: Tuple[float, float]) -> torch.Tensor:
    """Forward (B,3,3) affine in (x, y) convention: rotate+scale about
    ``center_yx``, then translate (albumentations A.Affine order).
    ``translate_yx`` (B,2), ``scale`` and ``angle_rad`` (B,)."""
    cy, cx = center_yx
    cos = torch.cos(angle_rad) * scale
    sin = torch.sin(angle_rad) * scale
    ty, tx = translate_yx[:, 0], translate_yx[:, 1]
    zero, one = torch.zeros_like(cos), torch.ones_like(cos)
    return torch.stack([
        torch.stack([cos, -sin, cx + tx - cos * cx + sin * cy], -1),
        torch.stack([sin, cos, cy + ty - sin * cx - cos * cy], -1),
        torch.stack([zero, zero, one], -1),
    ], -2)


def invert_affine(m: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (B,3,3) affines (last row 0 0 1)."""
    a, b, c = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    d, e, f = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    det = a * e - b * d
    det = torch.where(det.abs() < 1e-12, 1e-12, det)
    ia, ib = e / det, -b / det
    id_, ie = -d / det, a / det
    zero, one = torch.zeros_like(a), torch.ones_like(a)
    return torch.stack([
        torch.stack([ia, ib, -(ia * c + ib * f)], -1),
        torch.stack([id_, ie, -(id_ * c + ie * f)], -1),
        torch.stack([zero, zero, one], -1),
    ], -2)


def transform_points(m: torch.Tensor, pts_xy: torch.Tensor) -> torch.Tensor:
    """Apply (B,3,3) homographies to (B,N,2) xy points (forward). Written
    out term by term: fp32 on every device, whatever the matmul
    precision switches say."""
    x, y = pts_xy[..., 0], pts_xy[..., 1]
    mm = m[:, :, :, None]
    ox = x * mm[:, 0, 0] + y * mm[:, 0, 1] + mm[:, 0, 2]
    oy = x * mm[:, 1, 0] + y * mm[:, 1, 1] + mm[:, 1, 2]
    ow = x * mm[:, 2, 0] + y * mm[:, 2, 1] + mm[:, 2, 2]
    ow = torch.where(ow.abs() < 1e-8, 1e-8, ow)
    return torch.stack([ox / ow, oy / ow], -1)


def homography_from_points(src_xy: torch.Tensor, dst_xy: torch.Tensor) -> torch.Tensor:
    """(B,3,3) H with dst ~ H @ src from 4 point pairs (B,4,2): the 8x8 DLT
    system of each sample solved on the device. ``solve_ex`` does not check
    for singular systems, so the solve does not wait for the host. The
    system is solved in float64: its condition grows with the pixel
    coordinates, and two float32 LU factorizations (the card's, the host's)
    would disagree in the card's edge pixels; in float64 both round to the
    same float32 matrix but for the last bit."""
    x, y = src_xy[..., 0], src_xy[..., 1]
    u, v = dst_xy[..., 0], dst_xy[..., 1]
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    r1 = torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y], -1)
    r2 = torch.stack([zero, zero, zero, x, y, one, -v * x, -v * y], -1)
    a = torch.stack([r1, r2], -2).reshape(-1, 8, 8)  # rows 2i, 2i+1 per point
    b = dst_xy.reshape(-1, 8, 1)
    h8 = torch.linalg.solve_ex(a.double(), b.double())[0][..., 0].float()
    return torch.cat([h8, torch.ones_like(h8[:, :1])], -1).reshape(-1, 3, 3)


def gaussian_kernel_1d(sigma: torch.Tensor, radius: int) -> torch.Tensor:
    """Normalized 1-D Gaussian taps (B, 2*radius+1) for per-sample ``sigma``
    (B,)."""
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=sigma.device)
    k = torch.exp(-0.5 * (x / torch.clamp(sigma, min=1e-3)[:, None]) ** 2)
    return k / k.sum(-1, keepdim=True)


def gaussian_blur(img: torch.Tensor, sigma: torch.Tensor, radius: int = 3) -> torch.Tensor:
    """Separable Gaussian blur of (B,H,W,C) with per-sample ``sigma`` (B,),
    zero padding and no renormalisation at the edges (what the JAX
    package's two convolutions compute).

    Each pass multiplies the taps into a window view of the padded image
    and sums them, in float32 on every device. A cuDNN convolution would
    run as TF32 on the card whenever ``torch.backends.cudnn.allow_tf32`` is
    on (its default), so the blur would depend on a global switch."""
    k = gaussian_kernel_1d(sigma, radius)[:, None, None, None, :]
    x = img.float()
    x = F.pad(x, (0, 0, 0, 0, radius, radius)).unfold(1, 2 * radius + 1, 1)
    x = (x * k).sum(-1)
    x = F.pad(x, (0, 0, radius, radius)).unfold(2, 2 * radius + 1, 1)
    return (x * k).sum(-1)
