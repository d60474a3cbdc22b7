"""Plain reference of ``pose-hrnet-w18s``: HRNet-W18-small with the deconv
heatmap head, in float32 ``torch.nn.functional`` calls, and the corner
decode in float32 numpy, written from the paper and the configuration file.

Backbone: two 3x3 stride-2 stems (64), one bottleneck (32 x 4), then three
stages that grow branches at strides 4, 8, 16 and 32, two basic blocks per
branch, and full fusion (strided 3x3 convs down, 1x1 conv and nearest
upsampling up), every sum followed by ReLU. Head, from the coarsest
branch: two transpose convs (k4 s2, Flax ``SAME``: the input dilated by 2,
padded by 2 on each side, then correlated with the unflipped kernel), each
with BatchNorm and ReLU, two 3x3 conv-BN-ReLU, a 1x1 conv to the corner
heatmaps and a half-pixel bilinear resize to the heatmap size. BatchNorm
from its statistics; TF32 is off while it runs.

``precision="fp8"`` rounds each conv's input and kernel to float8 e4m3 with
a per-tensor scale (the usual fp8 recipe) and accumulates in float32: the
control that a comparison has to fail.

The decode is the served one: the integer arg-max (first maximum), a
quadratic sub-pixel step per axis, the completion of one dead corner by a
parallelogram, and, for a quadrilateral that is not plausible, the joint
decode over three peaks per corner with a collision penalty, reordered
around the centroid.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F


@contextlib.contextmanager
def ieee_fp32():
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def tensors(tree: Dict, device) -> Dict:
    """Leaves as float32 tensors on ``device``; 4-d kernels HWIO -> OIHW (a
    transpose conv's (kh, kw, in, out) -> (out, in, kh, kw), unflipped)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = tensors(v, device)
        else:
            t = torch.from_numpy(np.array(v, dtype=np.float32)).to(device)
            out[k] = t.permute(3, 2, 0, 1).contiguous() if t.dim() == 4 else t
    return out


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, back in float32."""
    scale = x.abs().amax().clamp_min(1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Net:
    def __init__(self, cfg: Dict, params: Dict, stats: Dict, device, precision: str = "fp32"):
        self.cfg = cfg
        self.p, self.s = tensors(params, device), tensors(stats, device)
        self.q = fp8 if precision == "fp8" else (lambda t: t)
        self.eps = cfg["bn_eps"]

    def bn(self, x, p, s):
        inv = p["scale"] / torch.sqrt(s["var"] + self.eps)
        return x * inv[None, :, None, None] + (p["bias"] - s["mean"] * inv)[None, :, None, None]

    def cbr(self, x, p, s, stride=1, act=True):
        w = p["conv"]["kernel"]
        y = F.conv2d(self.q(x), self.q(w), None, stride, (w.shape[-1] - 1) // 2)
        y = self.bn(y, p["bn"], s["bn"])
        return torch.relu(y) if act else y

    def basic(self, x, p, s):
        y = self.cbr(self.cbr(x, p["conv1"], s["conv1"]), p["conv2"], s["conv2"], act=False)
        if "proj" in p:
            x = self.cbr(x, p["proj"], s["proj"], act=False)
        return torch.relu(y + x)

    def bottleneck(self, x, p, s):
        y = self.cbr(self.cbr(x, p["conv1"], s["conv1"]), p["conv2"], s["conv2"])
        y = self.cbr(y, p["conv3"], s["conv3"], act=False)
        if "proj" in p:
            x = self.cbr(x, p["proj"], s["proj"], act=False)
        return torch.relu(y + x)

    @staticmethod
    def nearest(x, h, w):
        def idx(n_in, n_out):
            i = (torch.arange(n_out, dtype=torch.float32) * np.float32(n_in / n_out)).long()
            return i.clamp(max=n_in - 1).to(x.device)
        return x.index_select(2, idx(x.shape[2], h)).index_select(3, idx(x.shape[3], w))

    def deconv(self, x, w):
        b, c, h, wd = x.shape
        xd = x.new_zeros(b, c, 2 * h - 1, 2 * wd - 1)
        xd[:, :, ::2, ::2] = x
        return F.conv2d(F.pad(self.q(xd), (2, 2, 2, 2)), self.q(w))

    def heatmaps(self, images_u8: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8 -> (B, hm_h, hm_w, K) float32."""
        cfg, bp, bs = self.cfg, self.p["backbone"], self.s["backbone"]
        dev = images_u8.device
        mean = torch.tensor(cfg["image_mean"], device=dev)[None, :, None, None]
        std = torch.tensor(cfg["image_std"], device=dev)[None, :, None, None]
        x = (images_u8.permute(0, 3, 1, 2).float() / 255.0 - mean) / std
        x = self.cbr(x, bp["stem1"], bs["stem1"], stride=2)
        x = self.cbr(x, bp["stem2"], bs["stem2"], stride=2)
        x = self.bottleneck(x, bp["stage1_block0"], bs["stage1_block0"])
        branches = [x]
        for stage, channels in enumerate(cfg["stage_channels"]):
            new = []
            for b in range(len(channels)):
                name = f"t{stage}_b{b}"
                src = branches[b] if b < len(branches) else branches[-1]
                if name in bp:
                    src = self.cbr(src, bp[name], bs[name], stride=1 if b < len(branches) else 2)
                for blk in range(cfg["blocks_per_branch"]):
                    n = f"s{stage}_b{b}_blk{blk}"
                    src = self.basic(src, bp[n], bs[n])
                new.append(src)
            fp, fs = bp[f"fuse{stage}"], bs[f"fuse{stage}"]
            outs = []
            for i in range(len(new)):
                acc = 0.0
                for j, y in enumerate(new):
                    if j < i:
                        for st in range(i - j):
                            n = f"down{i}_{j}_{st}"
                            y = self.cbr(y, fp[n], fs[n], stride=2, act=st < i - j - 1)
                    elif j > i:
                        n = f"up{i}_{j}"
                        y = self.nearest(self.cbr(y, fp[n], fs[n], act=False),
                                         new[i].shape[2], new[i].shape[3])
                    acc = acc + y
                outs.append(torch.relu(acc))
            branches = outs
        x = branches[cfg["feature_index"]]
        hp, hs = self.p["head"], self.s["head"]
        for i in range(2):
            x = torch.relu(self.bn(self.deconv(x, hp[f"deconv{i}"]["kernel"]),
                                   hp[f"deconv_bn{i}"], hs[f"deconv_bn{i}"]))
        x = self.cbr(self.cbr(x, hp["conv0"], hs["conv0"]), hp["conv1"], hs["conv1"])
        x = F.conv2d(self.q(x), self.q(hp["final"]["kernel"]), hp["final"]["bias"])
        x = F.interpolate(x, size=tuple(cfg["heatmap_hw"]), mode="bilinear", align_corners=False)
        return x.permute(0, 2, 3, 1).contiguous()


# ---------------------------------------------------------------- decode (numpy)

def _subpixel(flat, py, px, vals, h, w):
    f32 = np.float32
    b_idx = np.arange(flat.shape[0])[:, None]
    k_idx = np.arange(flat.shape[2])[None, :]

    def at(yy, xx):
        return flat[b_idx, np.clip(yy, 0, h - 1) * w + np.clip(xx, 0, w - 1), k_idx]

    def refine(minus, plus, interior):
        denom = f32(2.0) * vals - plus - minus
        safe = np.where(denom == 0, f32(1.0), denom)
        with np.errstate(divide="ignore", invalid="ignore"):
            off = np.where(interior & (np.abs(denom) > f32(1e-6)),
                           f32(0.5) * (plus - minus) / safe, f32(0.0))
        return np.clip(off, f32(-0.5), f32(0.5)).astype(f32)

    off_x = refine(at(py, px - 1), at(py, px + 1), (px > 0) & (px < w - 1))
    off_y = refine(at(py - 1, px), at(py + 1, px), (py > 0) & (py < h - 1))
    return np.stack([(px.astype(f32) + off_x) / f32(w - 1),
                     (py.astype(f32) + off_y) / f32(h - 1)], axis=-1)


def _canonical(kp):
    """(B, K, 3) rows (x, y, conf) -> sorted by angle about the centroid,
    starting at the smallest x + y."""
    ctr = kp[..., :2].mean(axis=1, keepdims=True, dtype=np.float32)
    ang = np.arctan2(kp[..., 1] - ctr[..., 1], kp[..., 0] - ctr[..., 0])
    order = np.argsort(ang, axis=1, kind="stable")
    pts = np.take_along_axis(kp, order[..., None], axis=1)
    start = np.argmin(pts[..., 0] + pts[..., 1], axis=1)
    n = kp.shape[1]
    roll = (start[:, None] + np.arange(n)[None, :]) % n
    return np.take_along_axis(pts, roll[..., None], axis=1)


def _joint(flat, h, w, d):
    b, hw, k = flat.shape
    n = d["num_candidates"]
    ys = np.repeat(np.arange(h, dtype=np.float32), w)
    xs = np.tile(np.arange(w, dtype=np.float32), h)
    masked = flat.copy()
    picks = []
    for _ in range(n):
        idx = np.argmax(masked, axis=1)  # (B, K), first maximum
        picks.append(idx)
        d2 = (xs[None, :, None] - xs[idx][:, None, :]) ** 2 + \
             (ys[None, :, None] - ys[idx][:, None, :]) ** 2
        masked = np.where(d2 < np.float32(d["collision_px"]) ** 2, -np.inf, masked).astype(np.float32)
    idx3 = np.stack(picks, axis=-1)  # (B, K, n)
    conf3 = np.take_along_axis(flat.transpose(0, 2, 1), idx3, axis=2)
    x3, y3 = xs[idx3], ys[idx3]
    combos = np.array([[(c // n ** i) % n for i in range(k)] for c in range(n ** k)])
    kk = np.arange(k)[None, :]
    cx, cy, cc = x3[:, kk, combos], y3[:, kk, combos], conf3[:, kk, combos]
    d2c = (cx[..., None, :] - cx[..., :, None]) ** 2 + (cy[..., None, :] - cy[..., :, None]) ** 2
    collide = (d2c < np.float32(d["collision_px"]) ** 2) & ~np.eye(k, dtype=bool)
    score = cc.sum(-1, dtype=np.float32) - collide.sum(axis=(-1, -2)).astype(np.float32) * \
        np.float32(d["collision_penalty"])
    best = np.argmax(score, axis=1)
    rank = combos[best]  # (B, K)
    idx_best = np.take_along_axis(idx3, rank[..., None], axis=2)[..., 0]
    vals = np.take_along_axis(flat, idx_best[:, None, :], axis=1)[:, 0]
    c01 = _subpixel(flat, idx_best // w, idx_best % w, vals, h, w)
    size = np.array([w - 1, h - 1], np.float32)
    rows = _canonical(np.concatenate([c01 * size, vals[..., None]], axis=-1).astype(np.float32))
    return rows[..., :2] / size, rows[..., 2]


def _plausible(p, d):
    d2 = ((p[:, :, None, :] - p[:, None, :, :]) ** 2).sum(-1)
    d2[:, np.arange(p.shape[1]), np.arange(p.shape[1])] = np.inf
    distinct = d2.min(axis=(1, 2)) >= np.float32(d["min_dist"]) ** 2
    nxt = np.roll(p, -1, axis=1)
    e = nxt - p
    en = np.roll(e, -1, axis=1)
    convex = (e[..., 0] * en[..., 1] - e[..., 1] * en[..., 0] > 0).all(axis=1)
    area = np.float32(0.5) * np.abs((p[..., 0] * nxt[..., 1] - nxt[..., 0] * p[..., 1]).sum(1))
    return distinct & convex & (area >= np.float32(d["min_area"]))


def decode(cfg: Dict, heatmaps: np.ndarray, image_hw: Tuple[int, int]):
    """(B, h, w, K) float32 heatmaps -> ((B, K, 2) pixel xy, (B, K) conf)."""
    d = cfg["decode"]
    b, h, w, k = heatmaps.shape
    flat = np.ascontiguousarray(heatmaps, dtype=np.float32).reshape(b, h * w, k)
    idx = np.argmax(flat, axis=1)
    vals = flat.max(axis=1)
    c01 = _subpixel(flat, idx // w, idx % w, vals, h, w)
    # one dead corner, every other one live: a parallelogram completes it
    comp = np.roll(c01, -1, axis=1) + np.roll(c01, 1, axis=1) - np.roll(c01, 2, axis=1)
    dead = vals < np.float32(d["dead_conf"])
    others = np.where(np.eye(k, dtype=bool)[None], np.inf, vals[:, None, :]).min(-1)
    fire = dead & (others > np.float32(d["live_conf"])) & (dead.sum(1, keepdims=True) == 1)
    c01 = np.where(fire[..., None], comp, c01)
    size = np.array([w - 1, h - 1], np.float32)
    ok = _plausible(c01 * size, d)
    j01, jv = _joint(flat, h, w, d)
    c01 = np.where(ok[:, None, None], c01, j01)
    conf = np.where(ok[:, None], vals, jv)
    px = c01 * np.array([image_hw[1] - 1, image_hw[0] - 1], np.float32)
    return px.astype(np.float32), conf.astype(np.float32)


def judge(cfg: Dict, params: Dict, stats: Dict, inputs: np.ndarray, outputs: Dict,
          device, block: int = 16) -> Dict[str, float]:
    """Heatmaps served for ``inputs`` against the reference's, per image by
    the largest difference over the reference's largest magnitude; the
    served corners and confidences against the reference decode of the
    served heatmaps (the decode's own stage, on the program's heatmaps)."""
    hm_err = 0.0
    with ieee_fp32(), torch.no_grad():
        net = Net(cfg, params, stats, device)
        for i in range(0, len(inputs), block):
            x = torch.from_numpy(np.ascontiguousarray(inputs[i:i + block])).to(device)
            ref = net.heatmaps(x)
            got = torch.from_numpy(np.ascontiguousarray(outputs["heatmaps"][i:i + block])).to(device)
            err = (got - ref).abs().flatten(1).amax(1) / ref.abs().flatten(1).amax(1).clamp_min(1e-30)
            hm_err = max(hm_err, float(err.max()))
    px, conf = decode(cfg, outputs["heatmaps"], inputs.shape[1:3])
    return {"heatmap_err": hm_err,
            "corner_px": float(np.abs(px - outputs["corners"]).max()),
            "conf_err": float(np.abs(conf - outputs["conf"]).max())}
