"""Parameter checkpoints for serving (the serving half of the JAX package's
``training/checkpoint.py``).

One checkpoint ``<checkpoint_dir>/<name>/`` holds ``arrays.npz``: the
Flax-layout ``params`` and ``batch_stats`` trees as numpy arrays under
``/``-joined keys (``params/backbone/stem/conv/kernel``). Beside the
directory sits the ``<name>.meta.json`` sidecar (epoch, best_metric,
history, config). The JAX package writes Orbax checkpoints;
``tools/orbax_to_torch_checkpoint.py`` converts one into this format.

The full train state (optimizer, step, resume) is not part of this module.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np

ARRAYS = "arrays.npz"
_TREES = ("params", "batch_stats")


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
    ``checkpoint_dir``; returns its path.

    Crash-safe: the arrays go to a sibling ``<name>.staging`` directory and
    the existing checkpoint is replaced only after the new one is complete
    (write, then swap), so a failed save never destroys the previous one. A
    stale staging directory of an interrupted save is removed first."""
    path = os.path.abspath(os.path.join(checkpoint_dir, name))
    staging = path + ".staging"
    os.makedirs(checkpoint_dir, exist_ok=True)
    shutil.rmtree(staging, ignore_errors=True)
    os.makedirs(staging)
    flat = flatten_tree({"params": params, "batch_stats": batch_stats or {}})
    with open(os.path.join(staging, ARRAYS), "wb") as f:
        np.savez(f, **flat)
    # swap: drop the old checkpoint only now that the new one is complete
    if os.path.isdir(path):
        shutil.rmtree(path, ignore_errors=True)
    os.rename(staging, path)
    meta = {
        "epoch": int(epoch),
        "best_metric": None if best_metric is None else float(best_metric),
        "history": history or {},
        "config": config or {},
    }
    with open(os.path.join(checkpoint_dir, name + ".meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    return path


def _read_meta(checkpoint_dir: str, name: str) -> Dict[str, Any]:
    meta_path = os.path.join(checkpoint_dir, name + ".meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            return json.load(f)
    return {}


def load_params(
    checkpoint_dir: str, name: str
) -> Tuple[Dict[str, Any], Dict[str, Any], Dict[str, Any]]:
    """(params, batch_stats, meta) of checkpoint ``name`` as host numpy
    trees. Needs no model and no train state; the predictors move the
    weights to their device once, when they are built."""
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
        tree = unflatten_tree({k: data[k] for k in data.files})
    unknown = set(tree) - set(_TREES)
    if "params" not in tree or unknown:
        raise ValueError(f"{arrays}: want the trees {_TREES}, found {sorted(tree)}")
    return tree["params"], tree.get("batch_stats", {}), _read_meta(checkpoint_dir, name)
