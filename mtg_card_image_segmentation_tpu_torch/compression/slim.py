"""Physical channel removal ("slimming") for structured-pruned seg models
(copy of the JAX package's ``compression/slim.py``: numpy on Flax-layout
trees, with its own tree map).

1. ``expansion_channel_prune`` zeroes whole expansion channels inside the
   MobileNetV3 inverted-residual blocks: the expand conv's output column,
   the expand and depthwise BN scale and bias, and the depthwise kernel's
   channel. With BN scale AND bias zero the channel is exactly 0 after BN in
   eval mode, stays 0 through relu/hardswish (act(0) = 0), adds 0 to the SE
   pooled vector and 0 to the project conv: it is dead and removable.
2. ``slim_seg_state`` finds dead channels and slices every tensor that
   carries them (expand conv/bn, depthwise conv/bn, SE fc1 input rows and
   fc2 output columns, project conv input rows). It returns the smaller
   trees and the per-block ``expanded_overrides`` of the matching model.
   Outputs equal the masked model's: the same floating-point operations on
   the surviving channels.

Expansion channels are a free dimension (not tied to the residual stream),
so no cross-layer dependency analysis is needed.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from mtg_card_image_segmentation_tpu_torch.models.mobilenetv3 import (
    MOBILENET_V3_LARGE_ROWS,
)


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` on every leaf of a nested mapping; mappings become dicts."""
    if hasattr(tree, "items"):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaf_to_numpy(a) -> np.ndarray:
    if hasattr(a, "detach"):  # a torch tensor
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def _to_mutable(tree):
    """Plain dicts with host numpy leaves."""
    return tree_map(_leaf_to_numpy, tree)


def _block_has_expand(params: Dict[str, Any], i: int) -> bool:
    return "expand" in params["backbone"].get(f"block{i}", {})


def expansion_channel_prune(
    params: Dict[str, Any],
    amount: float = 0.3,
    ord: int = 2,
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Zero the ``amount`` fraction of lowest-norm expansion channels in
    every inverted-residual block that has a separate expand conv.

    Selection: L-``ord`` norm of the expand conv's output column (the
    per-layer criterion of torch ``ln_structured(dim=0)`` on the expand
    conv). Exactly ``floor(amount * E)`` channels per block are pruned.

    Returns (pruned_params, masks): masks are 1/0 trees over the same
    structure as params (1 everywhere except the zeroed slices).
    """
    params = _to_mutable(params)
    masks = tree_map(np.ones_like, params)

    for i in range(len(MOBILENET_V3_LARGE_ROWS)):
        if not _block_has_expand(params, i):
            continue
        blk = params["backbone"][f"block{i}"]
        mblk = masks["backbone"][f"block{i}"]
        kernel = np.asarray(blk["expand"]["conv"]["kernel"], np.float32)
        e = kernel.shape[-1]
        k = int(np.floor(amount * e))
        if k == 0:
            continue
        norms = np.linalg.norm(kernel.reshape(-1, e), ord=ord, axis=0)
        dead = np.argsort(norms, kind="stable")[:k]

        def zero(arr, axis):
            a = np.asarray(arr)
            sl = [slice(None)] * a.ndim
            sl[axis] = dead
            a = a.copy()
            a[tuple(sl)] = 0
            m = np.ones_like(a)
            m[tuple(sl)] = 0
            return a, m

        blk["expand"]["conv"]["kernel"], mblk["expand"]["conv"]["kernel"] = zero(
            blk["expand"]["conv"]["kernel"], -1
        )
        for p in ("scale", "bias"):
            blk["expand"]["bn"][p], mblk["expand"]["bn"][p] = zero(
                blk["expand"]["bn"][p], 0
            )
            blk["depthwise"]["bn"][p], mblk["depthwise"]["bn"][p] = zero(
                blk["depthwise"]["bn"][p], 0
            )
        blk["depthwise"]["conv"]["kernel"], mblk["depthwise"]["conv"]["kernel"] = zero(
            blk["depthwise"]["conv"]["kernel"], -1
        )

    return params, masks


def dead_expansion_channels(params: Dict[str, Any]) -> Dict[int, np.ndarray]:
    """Per-block indices of exactly-removable expansion channels: the expand
    kernel column is all-zero AND both BN affines (expand + depthwise
    scale/bias) are zero, so the channel's activation is identically 0."""
    out: Dict[int, np.ndarray] = {}
    for i in range(len(MOBILENET_V3_LARGE_ROWS)):
        if not _block_has_expand(params, i):
            continue
        blk = params["backbone"][f"block{i}"]
        kern = _leaf_to_numpy(blk["expand"]["conv"]["kernel"])
        cond = (np.abs(kern).max(axis=(0, 1, 2)) == 0)
        for sub in ("expand", "depthwise"):
            for p in ("scale", "bias"):
                cond &= _leaf_to_numpy(blk[sub]["bn"][p]) == 0
        dead = np.nonzero(cond)[0]
        # never slim a block to zero width
        if dead.size and dead.size < kern.shape[-1]:
            out[i] = dead
    return out


def slim_seg_state(
    params: Dict[str, Any],
    batch_stats: Optional[Dict[str, Any]] = None,
) -> Tuple[Dict[str, Any], Optional[Dict[str, Any]], Tuple[Optional[int], ...]]:
    """Physically remove dead expansion channels.

    Returns (slim_params, slim_batch_stats, expanded_overrides) where
    ``expanded_overrides`` is the tuple to pass to
    ``create_model(..., expanded_overrides=...)``. Entries are None for
    untouched blocks.
    """
    dead = dead_expansion_channels(params)
    params = _to_mutable(params)
    batch_stats = _to_mutable(batch_stats) if batch_stats is not None else None
    overrides: list[Optional[int]] = [None] * len(MOBILENET_V3_LARGE_ROWS)

    for i, dead_idx in dead.items():
        blk = params["backbone"][f"block{i}"]
        e = np.asarray(blk["expand"]["conv"]["kernel"]).shape[-1]
        keep = np.setdiff1d(np.arange(e), dead_idx)
        overrides[i] = int(keep.size)

        def take(arr, axis):
            return np.take(np.asarray(arr), keep, axis=axis)

        blk["expand"]["conv"]["kernel"] = take(blk["expand"]["conv"]["kernel"], -1)
        blk["depthwise"]["conv"]["kernel"] = take(
            blk["depthwise"]["conv"]["kernel"], -1
        )
        for sub in ("expand", "depthwise"):
            for p in ("scale", "bias"):
                blk[sub]["bn"][p] = take(blk[sub]["bn"][p], 0)
        if "se" in blk:
            blk["se"]["fc1"]["kernel"] = take(blk["se"]["fc1"]["kernel"], 2)
            blk["se"]["fc2"]["kernel"] = take(blk["se"]["fc2"]["kernel"], -1)
            blk["se"]["fc2"]["bias"] = take(blk["se"]["fc2"]["bias"], 0)
        blk["project"]["conv"]["kernel"] = take(blk["project"]["conv"]["kernel"], 2)

        if batch_stats is not None:
            sblk = batch_stats["backbone"][f"block{i}"]
            for sub in ("expand", "depthwise"):
                for p in ("mean", "var"):
                    sblk[sub]["bn"][p] = take(sblk[sub]["bn"][p], 0)

    return params, batch_stats, tuple(overrides)


def param_count(tree: Dict[str, Any]) -> int:
    total = 0
    for v in tree.values():
        total += param_count(v) if hasattr(v, "items") else int(np.prod(np.shape(v)))
    return total
