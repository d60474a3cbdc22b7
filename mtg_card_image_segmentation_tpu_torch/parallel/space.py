"""The mesh's ``space`` and ``model`` axes over ``torch.distributed`` ranks
(the JAX package gets the spatial split from GSPMD, which inserts halo
exchanges into sharded convolutions; ``parallel/mesh.py:8-10`` there).

A :class:`Layout` is one rank's place in the ``(hosts, data, space,
model)`` grid that ``make_mesh`` lays over the ranks (one device each, the
JAX reshape order, ``model`` fastest). Under :func:`use` (the train and
eval steps enter it) the port's models run spatially sharded:

- **The row partition.** A map of ``n`` rows is split over the ``S`` ranks
  of a space group as evenly as possible, rank ``k`` holding rows
  ``[ceil(k n / S), ceil((k+1) n / S))`` (:func:`bounds`). Where a layer
  divides ``n`` by its stride, output row ``o`` lies on the rank that holds
  input row ``o * s``; every map follows the rule, uneven and empty shards
  included.
- **Rows from their owners.** :class:`_FetchRows` hands every rank the
  global rows ``[lo, hi)`` it needs, from whichever ranks hold them
  (neighbours only where the halo fits in the adjacent shard, several ranks
  where it does not); its backward returns each row's gradient to its
  owner. A map's global row count comes from the ranks' local counts (one
  small gather on the host).
- **Helpers in global row coordinates**, each the plain op when no space
  group is in force: :func:`conv2d` (zero rows only at the global top and
  bottom), :func:`conv_transpose2d`, :func:`nearest_resize`,
  :func:`bilinear_resize` (source rows from the global half-pixel
  coordinates) and :func:`mean_hw` (sum and count all-reduced over the
  space group).
- **The model axis.** Ranks that differ only in their model index take the
  same rows of the same batch and compute the same thing: the JAX specs
  never name ``model``, so GSPMD replicates over it. The global-batch sums
  (BatchNorm, the losses, the metrics) are taken over the :attr:`batch
  group <Layout.batch_group>`, the ranks of one model index, so that no
  replica counts twice; DistributedDataParallel averages the gradients
  over every rank, which keeps the replicas equal.

Without a layout in force every helper is the plain op, bit for bit.
"""

from __future__ import annotations

import functools
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from mtg_card_image_segmentation_tpu_torch.ops import resize

_ACTIVE: Optional["Layout"] = None
# When a dict, the row exchanges (counts and rows) are timed into it:
# ``seconds`` and ``calls``, each exchange after a device synchronize, so
# that only its own copies and messages are counted (an instrument for the
# halo's share of a step; None in normal runs).
EXCHANGE_TIMER: Optional[dict] = None


@dataclass(frozen=True)
class Layout:
    """One rank's coordinates in the ``(hosts, data, space, model)`` grid
    and the process groups it joins: ``space_group`` (the ranks that share
    its hosts, data and model indices, in space order; None when ``space``
    is 1), ``meta_group`` (the same ranks on ``gloo``, for the row counts),
    ``batch_group`` (the ranks that share its model index; None when
    ``model`` is 1: the whole world)."""

    shape: Tuple[int, int, int, int]
    coords: Tuple[int, int, int, int]
    space_ranks: Tuple[int, ...]
    space_group: Optional[object]
    meta_group: Optional[object]
    batch_group: Optional[object]

    @property
    def space(self) -> int:
        return self.shape[2]

    @property
    def space_index(self) -> int:
        return self.coords[2]

    @property
    def data_count(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def data_index(self) -> int:
        return self.coords[0] * self.shape[1] + self.coords[1]

    @property
    def copies(self) -> int:
        """Ranks that hold the same batch slice: space x model."""
        return self.shape[2] * self.shape[3]


def grid_coords(rank: int, shape: Sequence[int]) -> Tuple[int, int, int, int]:
    """``rank``'s (hosts, data, space, model) indices in the JAX reshape
    order (``model`` fastest)."""
    _, d, s, m = shape
    return rank // (d * s * m), rank // (s * m) % d, rank // m % s, rank % m


def make_layout(shape: Sequence[int]) -> Layout:
    """This rank's :class:`Layout` for a grid ``shape`` that covers the
    world, one rank per cell. Every rank must call it (it makes the process
    groups, each on every rank in the same order)."""
    h, d, s, m = shape
    world, rank = dist.get_world_size(), dist.get_rank()
    gloo = dist.get_backend() == "gloo"
    mine = grid_coords(rank, shape)
    space_ranks: Tuple[int, ...] = (rank,)
    space_group = meta_group = batch_group = None
    if s > 1:
        for hi in range(h):
            for di in range(d):
                for mi in range(m):
                    ranks = [((hi * d + di) * s + si) * m + mi for si in range(s)]
                    g = dist.new_group(ranks)
                    g_meta = g if gloo else dist.new_group(ranks, backend="gloo")
                    if rank in ranks:
                        space_ranks, space_group, meta_group = tuple(ranks), g, g_meta
    if m > 1:
        for mi in range(m):
            g = dist.new_group([r for r in range(world) if r % m == mi])
            if mine[3] == mi:
                batch_group = g
    return Layout(tuple(shape), mine, space_ranks, space_group, meta_group, batch_group)


@contextmanager
def use(mesh):
    """Run the block under ``mesh``'s layout (nothing changes for a mesh
    without one: one rank per data shard, or none)."""
    global _ACTIVE
    kept = _ACTIVE
    _ACTIVE = getattr(mesh, "layout", None) or kept
    try:
        yield _ACTIVE
    finally:
        _ACTIVE = kept


def under(mesh):
    """Decorator: the function runs under :func:`use` of ``mesh``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with use(mesh):
                return fn(*args, **kwargs)
        return run
    return wrap


def layout() -> Optional[Layout]:
    """The layout in force, or None."""
    return _ACTIVE


def group() -> Optional[Layout]:
    """The layout in force when it splits rows (``space`` > 1), or None."""
    return _ACTIVE if _ACTIVE is not None and _ACTIVE.space > 1 else None


def batch_group():
    """The process group of the global-batch sums: the layout's batch group,
    or None (the whole world)."""
    return None if _ACTIVE is None else _ACTIVE.batch_group


def bounds(n: int, parts: int) -> List[int]:
    """The row partition of an ``n``-row map over ``parts`` ranks: rank k
    holds ``[b[k], b[k+1])`` with ``b[k] = ceil(k n / parts)``."""
    return [-(-k * n // parts) for k in range(parts + 1)]


def rows_of(lay: Optional[Layout], x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """This rank's rows (on ``dim``) under ``lay`` of ``x``, which holds
    every row of its maps: the whole of ``x`` without a space group."""
    if lay is None or lay.space == 1:
        return x
    b = bounds(x.shape[dim], lay.space)
    return x.narrow(dim, b[lay.space_index], b[lay.space_index + 1] - b[lay.space_index])


def shard_rows(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """:func:`rows_of` under the layout in force."""
    return rows_of(_ACTIVE, x, dim)


@contextmanager
def _timed():
    timer = EXCHANGE_TIMER
    if timer is None:
        yield
        return
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    yield
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    timer["seconds"] = timer.get("seconds", 0.0) + time.perf_counter() - t0
    timer["calls"] = timer.get("calls", 0) + 1


def _counts(sg: Layout, *local: int) -> List[List[int]]:
    """Every space rank's values of ``local`` (row counts), gathered on the
    host: ``[rank][i]``."""
    t = torch.tensor(local, dtype=torch.int64)
    out = [torch.empty_like(t) for _ in range(sg.space)]
    with _timed():
        dist.all_gather(out, t, group=sg.meta_group)
    return [o.tolist() for o in out]


def _wire(t: torch.Tensor, sg: Layout) -> torch.device:
    """Where ``t`` travels: gloo moves host tensors only."""
    if t.is_cuda and dist.get_backend(sg.space_group) == "gloo":
        return torch.device("cpu")
    return t.device


def _staged(t: torch.Tensor, sg: Layout) -> torch.Tensor:
    return t.to(_wire(t, sg)).contiguous()


def _exchange(sg: Layout, sends, recvs, like: torch.Tensor) -> List[torch.Tensor]:
    """Point-to-point over the space group: ``sends`` of (space index,
    tensor), ``recvs`` of (space index, shape); the received tensors on
    ``like``'s device and dtype."""
    ops, bufs = [], []
    with _timed():
        for j, t in sends:
            ops.append(dist.P2POp(dist.isend, _staged(t, sg), sg.space_ranks[j],
                                  sg.space_group))
        for j, shape in recvs:
            bufs.append(torch.empty(shape, dtype=like.dtype, device=_wire(like, sg)))
            ops.append(dist.P2POp(dist.irecv, bufs[-1], sg.space_ranks[j], sg.space_group))
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        return [b.to(like.device) for b in bufs]


def _overlap(a: Tuple[int, int], b: Tuple[int, int]) -> Tuple[int, int]:
    return max(a[0], b[0]), min(a[1], b[1])


class _FetchRows(torch.autograd.Function):
    """Rows ``want[k]`` (global, within the map) of a map whose space rank j
    holds ``own[j]``: the pieces come from their owners in row order.
    Backward: each piece's gradient goes back to its owner and is added to
    the owner's rows."""

    @staticmethod
    def forward(ctx, x, sg, dim, own, want):
        k = sg.space_index
        ctx.sg, ctx.dim, ctx.own, ctx.want = sg, dim, own, want
        ctx.x_shape = x.shape
        sends, recvs, pieces = [], [], []
        for j in range(sg.space):
            if j != k:
                a, b = _overlap(want[j], own[k])
                if a < b:
                    sends.append((j, x.narrow(dim, a - own[k][0], b - a)))
            a, b = _overlap(want[k], own[j])
            if a < b:
                if j == k:
                    pieces.append(x.narrow(dim, a - own[k][0], b - a))
                else:
                    shape = list(x.shape)
                    shape[dim] = b - a
                    recvs.append((j, shape))
                    pieces.append(None)
        got = iter(_exchange(sg, sends, recvs, x))
        parts = [p if p is not None else next(got) for p in pieces]
        if not parts:
            return x.narrow(dim, 0, 0).clone()
        return torch.cat(parts, dim) if len(parts) > 1 else parts[0].clone()

    @staticmethod
    def backward(ctx, grad):
        sg, dim, own, want = ctx.sg, ctx.dim, ctx.own, ctx.want
        k = sg.space_index
        gx = grad.new_zeros(ctx.x_shape)
        sends, recvs, local = [], [], None
        at = want[k][0]
        for j in range(sg.space):
            a, b = _overlap(want[k], own[j])
            if a < b:
                piece = grad.narrow(dim, a - at, b - a)
                if j == k:
                    local = (a, piece)
                else:
                    sends.append((j, piece))
            if j != k:
                a, b = _overlap(want[j], own[k])
                if a < b:
                    shape = list(ctx.x_shape)
                    shape[dim] = b - a
                    recvs.append((j, shape, a))
        got = _exchange(sg, sends, [(j, s) for j, s, _ in recvs], grad)
        for (_, _, a), g in zip(recvs, got):
            gx.narrow(dim, a - own[k][0], g.shape[dim]).add_(g)
        if local is not None:
            a, piece = local
            gx.narrow(dim, a - own[k][0], piece.shape[dim]).add_(piece)
        return gx, None, None, None, None


def _own(counts: Sequence[int]) -> List[Tuple[int, int]]:
    """The global row range of each rank's rows, from their counts."""
    s = np.concatenate([[0], np.cumsum(counts)]).tolist()
    return [(s[j], s[j + 1]) for j in range(len(counts))]


def _fetch(x: torch.Tensor, sg: Layout, dim: int, own, want) -> torch.Tensor:
    """Rows ``want[k]`` clipped to the map, from their owners."""
    n = own[-1][1]
    want = [(min(max(lo, 0), n), min(max(hi, 0), n)) if lo < hi else (0, 0)
            for lo, hi in want]
    return _FetchRows.apply(x, sg, dim, own, want)


def _empty(shape, like: torch.Tensor, *connected: Optional[torch.Tensor]) -> torch.Tensor:
    """A zero-row result still joined to ``connected`` in the autograd
    graph (zero gradients), so that every rank runs the same backward
    exchanges."""
    out = like.new_zeros(shape)
    for t in connected:
        if t is not None:
            out = out + t.sum() * 0
    return out


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
           stride: int = 1, padding: int = 0, dilation: int = 1,
           groups: int = 1) -> torch.Tensor:
    """``F.conv2d`` of NCHW ``x`` with symmetric ``padding``; under a space
    group, this rank's output rows from the input rows they need (``p``
    above, ``(k-1)·d - p - (s-1)`` below where the stride divides the map),
    zero rows only beyond the global top and bottom."""
    sg = group()
    if sg is None:
        return F.conv2d(x, weight, bias, stride, padding, dilation, groups)
    k, s, p, d = weight.shape[2], stride, padding, dilation
    w_out = (x.shape[3] + 2 * p - d * (weight.shape[3] - 1) - 1) // s + 1
    if k == 1 and s == 1:
        if x.shape[2] == 0:
            return _empty((x.shape[0], weight.shape[0], 0, w_out), x, x, weight, bias)
        return F.conv2d(x, weight, bias, 1, (0, p), d, groups)
    own = _own([c[0] for c in _counts(sg, x.shape[2])])
    n_in = own[-1][1]
    n_out = (n_in + 2 * p - d * (k - 1) - 1) // s + 1
    ob = bounds(n_out, sg.space)
    want = [(ob[j] * s - p, (ob[j + 1] - 1) * s - p + d * (k - 1) + 1)
            if ob[j] < ob[j + 1] else (0, 0) for j in range(sg.space)]
    rows = _fetch(x, sg, 2, own, want)
    j = sg.space_index
    if ob[j] == ob[j + 1]:
        return _empty((x.shape[0], weight.shape[0], 0, w_out), x, rows, weight, bias)
    lo, hi = want[j]
    rows = F.pad(rows, (0, 0, max(0, -lo), max(0, hi - n_in)))
    return F.conv2d(rows, weight, bias, s, (0, p), d, groups)


def conv_transpose2d(x: torch.Tensor, weight: torch.Tensor, stride: int,
                     padding: int) -> torch.Tensor:
    """``F.conv_transpose2d`` of NCHW ``x`` (no bias); under a space group,
    this rank's output rows from the input rows that reach them."""
    sg = group()
    if sg is None:
        return F.conv_transpose2d(x, weight, None, stride=stride, padding=padding)
    k, s, p = weight.shape[2], stride, padding
    own = _own([c[0] for c in _counts(sg, x.shape[2])])
    n_in = own[-1][1]
    n_out = (n_in - 1) * s - 2 * p + k
    w_out = (x.shape[3] - 1) * s - 2 * p + weight.shape[3]
    ob = bounds(n_out, sg.space)
    want = [(-(-(ob[j] + p - k + 1) // s), (ob[j + 1] - 1 + p) // s + 1)
            if ob[j] < ob[j + 1] else (0, 0) for j in range(sg.space)]
    rows = _fetch(x, sg, 2, own, want)
    j = sg.space_index
    if ob[j] == ob[j + 1]:
        return _empty((x.shape[0], weight.shape[1], 0, w_out), x, rows, weight)
    lo = min(max(want[j][0], 0), n_in)
    full = F.conv_transpose2d(rows, weight, None, stride=(s, s), padding=(0, p))
    return full.narrow(2, ob[j] - lo * s + p, ob[j + 1] - ob[j])


def _resize_rows(x: torch.Tensor, out_h: int, global_h: bool):
    """(space layout, own row ranges of ``x``, its global rows, the output's
    global rows and bounds) for a resize of NHWC ``x`` to ``out_h`` rows:
    this rank's rows of the target map, or its global rows."""
    sg = group()
    counts = _counts(sg, x.shape[1], 0 if global_h else out_h)
    own = _own([c[0] for c in counts])
    n_out = out_h if global_h else sum(c[1] for c in counts)
    return sg, own, own[-1][1], n_out, bounds(n_out, sg.space)


def nearest_resize(x: torch.Tensor, out_h: int, out_w: int,
                   global_h: bool = False) -> torch.Tensor:
    """``ops/resize.py::nearest_resize`` of NHWC ``x``. Under a space group
    ``out_h`` is this rank's rows of the target map (``global_h``: the
    target's global rows), and the source rows follow the global index
    rule."""
    if group() is None:
        return resize.nearest_resize(x, out_h, out_w)
    sg, own, n_in, n_out, ob = _resize_rows(x, out_h, global_h)
    idx = resize.nearest_indices(n_in, n_out)
    want = [(int(idx[ob[j]]), int(idx[ob[j + 1] - 1]) + 1) if ob[j] < ob[j + 1] else (0, 0)
            for j in range(sg.space)]
    rows = _fetch(x, sg, 1, own, want)
    j = sg.space_index
    if ob[j] == ob[j + 1]:
        return _empty((x.shape[0], 0, out_w, x.shape[3]), x, rows)
    sel = torch.from_numpy(idx[ob[j]:ob[j + 1]] - want[j][0]).to(x.device)
    idx_w = torch.from_numpy(resize.nearest_indices(x.shape[2], out_w)).to(x.device)
    return rows.index_select(1, sel).index_select(2, idx_w)


def bilinear_resize(x: torch.Tensor, out_h: int, out_w: int,
                    global_h: bool = False) -> torch.Tensor:
    """``ops/resize.py::bilinear_resize`` of NHWC ``x`` (half-pixel, in
    float32, cast back). Under a space group ``out_h`` is read as in
    :func:`nearest_resize`, and each output row lerps the two source rows
    of its global half-pixel coordinate."""
    if group() is None:
        return resize.bilinear_resize(x, out_h, out_w)
    sg, own, n_in, n_out, ob = _resize_rows(x, out_h, global_h)
    j = sg.space_index
    if n_in == n_out:
        return resize.bilinear_resize(x, x.shape[1], out_w)
    lo, hi, w = resize.half_pixel_coords(n_in, n_out)
    want = [(int(lo[ob[i]]), int(hi[ob[i + 1] - 1]) + 1) if ob[i] < ob[i + 1] else (0, 0)
            for i in range(sg.space)]
    rows = _fetch(x, sg, 1, own, want)
    if ob[j] == ob[j + 1]:
        return _empty((x.shape[0], 0, out_w, x.shape[3]), x, rows)
    base, sl = want[j][0], slice(ob[j], ob[j + 1])
    xf = rows.float()
    top = xf.index_select(1, torch.from_numpy(lo[sl].astype(np.int64) - base).to(x.device))
    bot = xf.index_select(1, torch.from_numpy(hi[sl].astype(np.int64) - base).to(x.device))
    xf = top + (bot - top) * torch.from_numpy(w[sl]).to(x.device)[None, :, None, None]
    return resize.bilinear_resize(xf, xf.shape[1], out_w).to(x.dtype)


def mean_hw(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The (B, C) mean of NHWC ``x`` over H and W in ``dtype``; under a space
    group the rows' sum and count all-reduced over it (with a backward)."""
    sg = group()
    if sg is None:
        return x.mean(dim=(1, 2), dtype=dtype)
    from torch.distributed.nn.functional import all_reduce

    s = x.sum(dim=(1, 2), dtype=dtype)
    total = all_reduce(torch.cat([s, s.new_full((s.shape[0], 1), x.shape[1] * x.shape[2])],
                                 1), group=sg.space_group)
    return total[:, :-1] / total[:, -1:]


def gather_rows(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """Every row of a row-split map, on every rank of the space group (no
    backward); ``x`` itself without one."""
    sg = group()
    if sg is None:
        return x
    counts = [c[0] for c in _counts(sg, x.shape[dim])]
    top = max(counts)
    pad = list(x.shape)
    pad[dim] = top - x.shape[dim]
    t = _staged(torch.cat([x, x.new_zeros(pad)], dim), sg)
    parts = [torch.empty_like(t) for _ in range(sg.space)]
    dist.all_gather(parts, t, group=sg.space_group)
    return torch.cat([p.narrow(dim, 0, c) for p, c in zip(parts, counts)], dim).to(x.device)


def distinct(gathered: torch.Tensor) -> torch.Tensor:
    """Of a world-wide ``all_gather_cat`` of equal per-rank blocks, the
    blocks of distinct batch slices (space and model index 0): the copies
    of a space group or a model replica counted once."""
    lay = _ACTIVE
    if lay is None or lay.copies == 1:
        return gathered
    world = dist.get_world_size()
    return gathered.reshape(world, -1, *gathered.shape[1:])[::lay.copies].flatten(0, 1)
