"""Seeded weights in the Flax layout, made on the device in two large calls.

A configuration file lists every leaf of its model's ``params`` and
``batch_stats`` trees as ``[path, shape, "normal", std]`` or ``[path, shape,
"uniform", lo, hi]``. One ``torch.Generator`` on the run's device, seeded
from ``--seed``, draws every normal leaf in one ``randn`` call and every
uniform leaf in one ``rand`` call, in the file's order; the leaves are
slices of those two buffers. The trees go to the host once, as float32
numpy arrays: the program's entry takes them there (and folds what it
folds), and the reference reads the very same arrays.

Weight values do not change how fast these models run; their scales
(LeCun-normal kernels, BatchNorm statistics moved off 0 and 1) keep every
layer's activations of order one, so outputs are neither constant nor
overflowing.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

SEED_MASK = (1 << 63) - 1


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` seeded from ``seed`` and a stream number
    (weights 0, inputs 1, ...), so that the draws of one run never overlap
    and a large ``--seed`` is taken whole."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream * 7_919 + 12_345) & SEED_MASK)
    return g


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for path, a in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = a
    return tree


def make_trees(config: dict, seed: int, device) -> Tuple[Dict, Dict]:
    """(params, batch_stats): nested dicts of float32 numpy arrays."""
    leaves = [("params", *x) for x in config["leaves"]["params"]]
    leaves += [("batch_stats", *x) for x in config["leaves"]["batch_stats"]]
    sizes = [int(np.prod(x[2])) for x in leaves]
    n_normal = sum(n for x, n in zip(leaves, sizes) if x[3] == "normal")
    n_uniform = sum(n for x, n in zip(leaves, sizes) if x[3] == "uniform")
    g = generator(seed, device)
    normal = torch.randn(n_normal, generator=g, device=device)
    uniform = torch.rand(n_uniform, generator=g, device=device)
    # each leaf's std, lo and hi spread over its slice in one call each
    def spread(kind, col):
        vals = [float(x[col]) for x in leaves if x[3] == kind]
        reps = [n for x, n in zip(leaves, sizes) if x[3] == kind]
        return torch.repeat_interleave(torch.tensor(vals, device=device),
                                       torch.tensor(reps, device=device),
                                       output_size=sum(reps))

    std, lo, hi = spread("normal", 4), spread("uniform", 4), spread("uniform", 5)
    normal = (normal * std).cpu().numpy()
    uniform = (lo + uniform * (hi - lo)).cpu().numpy()
    flat = {"params": {}, "batch_stats": {}}
    offs = {"normal": 0, "uniform": 0}
    for x, n in zip(leaves, sizes):
        tree, path, shape, kind = x[0], x[1], tuple(x[2]), x[3]
        src = normal if kind == "normal" else uniform
        flat[tree][path] = src[offs[kind]:offs[kind] + n].reshape(shape)
        offs[kind] += n
    return _unflatten(flat["params"]), _unflatten(flat["batch_stats"])
