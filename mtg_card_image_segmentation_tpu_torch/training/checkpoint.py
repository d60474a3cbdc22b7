"""Checkpoints with the best/periodic/final policy (counterpart of the JAX
package's ``training/checkpoint.py``).

One checkpoint ``<checkpoint_dir>/<name>/`` holds ``arrays.npz``: the
Flax-layout ``params`` and ``batch_stats`` trees as numpy arrays under
``/``-joined keys (``params/backbone/stem/conv/kernel``), and, when it was
written from a train state (:func:`save_checkpoint`), the optimizer's
moments (``opt_state/mu/...``, ``opt_state/nu/...`` for AdamW,
``opt_state/trace/...`` for SGD, ``opt_state/count``) and ``step``, so a
resumed run continues exactly. Beside the directory sits the
``<name>.meta.json`` sidecar (epoch, best_metric, history, config).
:func:`load_params` reads the parameters and statistics of either kind and
never the optimizer's arrays. The JAX package writes Orbax checkpoints;
``tools/orbax_to_torch_checkpoint.py`` converts one into this format.

Under a ``torch.distributed`` process group rank 0 alone writes, between
barriers that every rank passes (the JAX package writes from one process,
``training/checkpoint.py:60-80``); every rank reads. The trees are those of
the unwrapped model, so a checkpoint written by a group loads in one
process and the other way round.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from mtg_card_image_segmentation_tpu_torch.parallel import distributed

ARRAYS = "arrays.npz"
_TREES = ("params", "batch_stats")
_STATE_TREES = ("opt_state", "step")


def flatten_tree(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested mapping -> {"a/b/c": array}; torch leaves go through numpy."""
    flat: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        if "/" in key:
            raise ValueError(f"tree key {key!r} holds the separator '/'")
        path = f"{prefix}/{key}" if prefix else key
        if hasattr(val, "items"):
            flat.update(flatten_tree(val, path))
        else:
            if hasattr(val, "detach"):
                val = val.detach().cpu().numpy()
            flat[path] = np.asarray(val)
    return flat


def unflatten_tree(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, val in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


def _write(checkpoint_dir: str, name: str, trees: Callable[[], Dict[str, Any]],
           meta: Dict[str, Any]) -> str:
    """Write ``trees()`` and the meta sidecar as checkpoint ``name``: on
    rank 0 alone, between two barriers of every rank (the second also when
    the write fails, so that no rank is left waiting).

    Crash-safe: the arrays go to a sibling ``<name>.staging`` directory and
    the existing checkpoint is replaced only after the new one is complete
    (write, then swap), so a failed save never destroys the previous one. A
    stale staging directory of an interrupted save is removed first, and a
    failed write is retried once from a clean slate."""
    path = os.path.abspath(os.path.join(checkpoint_dir, name))
    distributed.barrier()
    try:
        if distributed.process_index() == 0:
            _write_here(checkpoint_dir, name, path, trees(), meta)
    finally:
        distributed.barrier()
    return path


def _write_here(checkpoint_dir: str, name: str, path: str, trees: Dict[str, Any],
                meta: Dict[str, Any]) -> None:
    staging = path + ".staging"
    os.makedirs(checkpoint_dir, exist_ok=True)
    flat = flatten_tree(trees)
    for attempt in range(2):
        shutil.rmtree(staging, ignore_errors=True)
        try:
            os.makedirs(staging)
            with open(os.path.join(staging, ARRAYS), "wb") as f:
                np.savez(f, **flat)
            break
        except Exception:
            if attempt == 1:
                raise
    # swap: drop the old checkpoint only now that the new one is complete
    if os.path.isdir(path):
        shutil.rmtree(path, ignore_errors=True)
    os.rename(staging, path)
    with open(os.path.join(checkpoint_dir, name + ".meta.json"), "w") as f:
        json.dump(meta, f, indent=2)


def _meta(epoch: int, best_metric: Optional[float], history: Optional[dict],
          config: Optional[dict]) -> Dict[str, Any]:
    return {
        "epoch": int(epoch),
        "best_metric": None if best_metric is None else float(best_metric),
        "history": history or {},
        "config": config or {},
    }


def save_params(
    checkpoint_dir: str,
    name: str,
    params: Dict[str, Any],
    batch_stats: Optional[Dict[str, Any]] = None,
    epoch: int = 0,
    best_metric: Optional[float] = None,
    history: Optional[dict] = None,
    config: Optional[dict] = None,
) -> str:
    """Write checkpoint ``name`` (e.g. 'best_model', 'final_model') under
    ``checkpoint_dir`` with parameters and statistics only; returns its
    path (write-then-swap, see :func:`_write`)."""
    return _write(checkpoint_dir, name,
                  lambda: {"params": params, "batch_stats": batch_stats or {}},
                  _meta(epoch, best_metric, history, config))


def save_checkpoint(
    checkpoint_dir: str,
    name: str,
    state,
    epoch: int,
    best_metric: Optional[float] = None,
    history: Optional[dict] = None,
    config: Optional[dict] = None,
) -> str:
    """Write the whole train state ``state`` (``training.state.SegTrainState``:
    parameters, statistics, optimizer moments, step) as checkpoint ``name``
    (e.g. 'best_model', 'checkpoint_epoch_10', 'final_model'); returns its
    path. Write-then-swap with stale-staging cleanup and one retry
    (:func:`_write`)."""
    def trees():
        out = dict(state.variables())
        out["opt_state"] = state.opt_state()
        out["step"] = np.asarray(state.step, np.int64)
        return out

    return _write(checkpoint_dir, name, trees, _meta(epoch, best_metric, history, config))


def try_save_checkpoint(log, *args, **kwargs) -> Optional[str]:
    """Non-fatal save for mid-training best/periodic checkpoints: a long run
    survives a transient filesystem failure. Returns the path, or None on
    failure (logged)."""
    try:
        return save_checkpoint(*args, **kwargs)
    except Exception:
        log.exception("checkpoint save failed (continuing training)")
        return None


def _read_meta(checkpoint_dir: str, name: str) -> Dict[str, Any]:
    meta_path = os.path.join(checkpoint_dir, name + ".meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            return json.load(f)
    return {}


def read_arrays(checkpoint_dir: str, name: str, trees: Tuple[str, ...]) -> Dict[str, Any]:
    """The top-level ``trees`` of checkpoint ``name`` as host numpy trees;
    the arrays of other trees are never read from disk."""
    path = os.path.abspath(os.path.join(checkpoint_dir, name))
    arrays = os.path.join(path, ARRAYS)
    if not os.path.isfile(arrays):
        # e.g. a checkpoint whose binaries are not tracked in git, so that
        # only the .meta.json survives
        hint = ""
        if os.path.isdir(path) and os.listdir(path):
            hint = (" The directory holds other files: an Orbax checkpoint of the "
                    "JAX package is converted with tools/orbax_to_torch_checkpoint.py.")
        raise FileNotFoundError(
            f"no checkpoint at {path!r} (directory missing or empty — "
            "checkpoint binaries are not tracked in git; re-run training or "
            f"point --checkpoint at a real run).{hint}"
        )
    with np.load(arrays, allow_pickle=False) as data:
        found = {k.split("/", 1)[0] for k in data.files}
        if "params" not in found or found - set(_TREES + _STATE_TREES):
            raise ValueError(f"{arrays}: want the trees {_TREES + _STATE_TREES}, "
                             f"found {sorted(found)}")
        tree = unflatten_tree({k: data[k] for k in data.files
                               if k.split("/", 1)[0] in trees})
    return tree


def load_params(
    checkpoint_dir: str, name: str
) -> Tuple[Dict[str, Any], Dict[str, Any], Dict[str, Any]]:
    """(params, batch_stats, meta) of checkpoint ``name`` as host numpy
    trees. Needs no model and no train state, and reads no optimizer
    array; the predictors move the weights to their device once, when they
    are built."""
    tree = read_arrays(checkpoint_dir, name, _TREES)
    return tree["params"], tree.get("batch_stats", {}), _read_meta(checkpoint_dir, name)


def load_checkpoint(checkpoint_dir: str, name: str, state,
                    params_only: bool = False) -> Tuple[Any, Dict[str, Any]]:
    """Restore checkpoint ``name`` into ``state`` (in place) and return
    (state, meta). ``params_only`` restores parameters, statistics and the
    step but not the optimizer's moments (a consumer whose optimizer
    differs from the writer's)."""
    tree = read_arrays(checkpoint_dir, name, _TREES + _STATE_TREES)
    state.load_variables(tree["params"], tree.get("batch_stats", {}))
    if "step" not in tree:
        raise ValueError(f"checkpoint {name!r} holds no train state (written by save_params)")
    if params_only:
        state.step = int(tree["step"])
    else:
        state.load_opt_state(tree["opt_state"])
        if int(tree["opt_state"]["count"]) != int(tree["step"]):
            raise ValueError(f"checkpoint {name!r}: optimizer count and step differ")
    return state, _read_meta(checkpoint_dir, name)


def latest_checkpoint_name(checkpoint_dir: str) -> Optional[str]:
    """Most recently written checkpoint under ``checkpoint_dir`` (for resume
    without an explicit name); an interrupted save's staging directory is
    not one."""
    if not os.path.isdir(checkpoint_dir):
        return None
    candidates = [
        d
        for d in os.listdir(checkpoint_dir)
        if os.path.isdir(os.path.join(checkpoint_dir, d)) and not d.endswith(".staging")
    ]
    if not candidates:
        return None
    return max(
        candidates, key=lambda d: os.path.getmtime(os.path.join(checkpoint_dir, d))
    )
