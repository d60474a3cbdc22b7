"""Weight pruning on Flax-layout param trees (counterpart of the JAX
package's ``compression/prune.py``).

Behavioral spec: train/prune.py — global L1 unstructured pruning over all
conv weights (:68-72), or per-conv structured channel pruning (:76-93),
sparsity statistics + compression ratio (:115-141), fine-tune at 0.1x lr
(:172-239), permanent mask removal (:102-113).

The pruning functions work on the Flax layout (HWIO kernels), as the JAX
package does, with numpy on the host: structured pruning removes output
channels, the last axis of HWIO, where torch's OIHW weights would put them
first. A tree of the model's weights comes from
``utils.params.state_dict_to_flax`` and goes back through
``trainable_from_flax``. They return (pruned_params, masks) numpy trees; the
fine-tune keeps sparsity exact with :func:`masked_optimizer`. "Mask
removal" is a no-op here: the params are literally zero.

Unstructured sparsity does not speed up dense convolutions; it is a
compression tool. Expansion channels pruned by ``compression/slim.py`` can
be removed physically (``slim_seg_state``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from mtg_card_image_segmentation_tpu_torch.compression.slim import (
    _leaf_to_numpy,
    _to_mutable,
    tree_map,
)
from mtg_card_image_segmentation_tpu_torch.training.optim import OptimizerDef
from mtg_card_image_segmentation_tpu_torch.utils.params import flax_to_state_dict


def _leaves(tree: Dict[str, Any], path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _set(tree: Dict[str, Any], path: Tuple[str, ...], value) -> None:
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _is_prunable(path: Tuple[str, ...], leaf) -> bool:
    """Prune conv/dense kernels only (reference prunes Conv2d weights,
    train/prune.py:55-66) — never biases or BN scales. Depthwise kernels
    count."""
    return path[-1] == "kernel" and np.ndim(leaf) >= 2


def _quantile_linear_f32(values: np.ndarray, q: float) -> np.float32:
    """``jnp.quantile(values, q)`` (linear interpolation) in float32, with
    its arithmetic: rank ``q * (n - 1)`` in float32, then
    ``low * (1 - w) + high * w``. ``torch.quantile`` refuses inputs above
    2^24 elements and interpolates with ``lerp``, so the sort and the
    interpolation are written out."""
    srt = np.sort(values.astype(np.float32))
    n = np.float32(srt.size)
    rank = np.float32(q) * (n - np.float32(1))
    low, high = np.floor(rank), np.ceil(rank)
    high_w = np.float32(rank - low)
    low_w = np.float32(1) - high_w
    lo = int(np.clip(low, 0, srt.size - 1))
    hi = int(np.clip(high, 0, srt.size - 1))
    return np.float32(srt[lo] * low_w + srt[hi] * high_w)


def magnitude_prune(params: Dict[str, Any], amount: float = 0.3
                    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Global L1 unstructured pruning: zero the ``amount`` fraction of
    smallest-magnitude weights across ALL prunable kernels (one global
    threshold — torch prune.global_unstructured semantics)."""
    params = _to_mutable(params)
    prunable = [np.abs(v).ravel() for p, v in _leaves(params) if _is_prunable(p, v)]
    if not prunable:
        raise ValueError("no prunable kernels found")
    threshold = _quantile_linear_f32(np.concatenate(prunable), amount)
    masks = tree_map(np.ones_like, params)
    for path, leaf in list(_leaves(params)):
        if _is_prunable(path, leaf):
            mask = (np.abs(leaf) >= threshold).astype(leaf.dtype)
            _set(params, path, leaf * mask)
            _set(masks, path, mask)
    return params, masks


def structured_channel_prune(params: Dict[str, Any], amount: float = 0.3, ord: int = 2
                             ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Per-kernel structured pruning: zero the ``amount`` fraction of output
    channels with the smallest L-``ord`` norm (torch ln_structured(dim=0)
    on OIHW == the last axis of HWIO kernels)."""
    params = _to_mutable(params)
    masks = tree_map(np.ones_like, params)
    for path, leaf in list(_leaves(params)):
        if not _is_prunable(path, leaf) or leaf.shape[-1] <= 1:
            continue
        k = int(np.floor(amount * leaf.shape[-1]))
        if k == 0:
            continue
        norms = np.linalg.norm(leaf.reshape(-1, leaf.shape[-1]).astype(np.float32),
                               ord=ord, axis=0)
        # exactly the k smallest-norm channels (a stable argsort, as
        # jnp.argsort; a threshold compare could over-prune at a tie)
        ch_mask = np.ones(leaf.shape[-1], leaf.dtype)
        ch_mask[np.argsort(norms, kind="stable")[:k]] = 0
        mask = np.broadcast_to(ch_mask, leaf.shape).copy()
        _set(params, path, leaf * mask)
        _set(masks, path, mask)
    return params, masks


def apply_masks(params: Dict[str, Any], masks: Dict[str, Any]) -> Dict[str, Any]:
    """``params * masks`` leaf by leaf (numpy trees)."""
    out = _to_mutable(params)
    for path, leaf in list(_leaves(out)):
        m = masks
        for k in path:
            m = m[k]
        _set(out, path, leaf * _leaf_to_numpy(m))
    return out


@dataclasses.dataclass(frozen=True)
class MaskedOptimizerDef(OptimizerDef):
    """An :class:`OptimizerDef` whose updates keep pruned weights at exactly
    zero: ``masks`` (one 0/1 tensor per parameter, in the order of
    ``model.parameters()``, on the parameters' device) multiply the
    gradients before the update and the parameters after it, so AdamW's
    decoupled weight decay cannot bring a zero back. This is optax's "mask
    the updates before and after" in torch's in-place idiom."""

    masks: Tuple[torch.Tensor, ...] = ()

    def build(self, params) -> torch.optim.Optimizer:
        params = list(params)
        if [tuple(p.shape) for p in params] != [tuple(m.shape) for m in self.masks]:
            raise ValueError("the masks do not match the parameters")
        return super().build(params)

    def step(self, opt: torch.optim.Optimizer, count: int) -> None:
        params = [p for g in opt.param_groups for p in g["params"]]
        with torch.no_grad():
            for p, m in zip(params, self.masks):
                if p.grad is not None:
                    p.grad.mul_(m)
        super().step(opt, count)
        with torch.no_grad():
            for p, m in zip(params, self.masks):
                p.mul_(m)


def masked_optimizer(opt_def: OptimizerDef, masks: Dict[str, Any],
                     model: torch.nn.Module) -> MaskedOptimizerDef:
    """``opt_def`` with sparsity preservation for ``model``: ``masks`` is a
    Flax-layout 0/1 tree over the model's params (as the pruning functions
    return it), laid out here as the model's parameters."""
    sd = flax_to_state_dict(masks)
    named = list(model.named_parameters())
    if set(sd) != {n for n, _ in named}:
        raise ValueError("the masks do not cover the model's parameters")
    ordered = tuple(sd[n].to(device=p.device, dtype=p.dtype) for n, p in named)
    fields = {f.name: getattr(opt_def, f.name) for f in dataclasses.fields(OptimizerDef)}
    return MaskedOptimizerDef(**fields, masks=ordered)


def sparsity_report(params: Dict[str, Any]) -> Dict[str, Any]:
    """Per-layer + global sparsity stats (train/prune.py:115-141)."""
    layers = {}
    total = 0
    zeros = 0
    for path, leaf in _leaves(params):
        if not _is_prunable(path, leaf):
            continue
        leaf = _leaf_to_numpy(leaf)
        z = int(np.sum(leaf == 0))
        n = int(np.prod(leaf.shape))
        layers["/".join(path)] = {"sparsity": z / n, "params": n}
        total += n
        zeros += z
    return {
        "global_sparsity": zeros / max(total, 1),
        "prunable_params": total,
        "nonzero_params": total - zeros,
        "compression_ratio": total / max(total - zeros, 1),
        "layers": layers,
    }
