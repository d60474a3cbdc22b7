"""Model FLOPs of ``seg-mnv3l-lraspp`` per image: 2 per multiply-add of
every conv and product of the plain reference's forward at the given
input size, counted by ``torch.utils.flop_counter`` on meta tensors (no
data, no device), so that every implementation is read against the same
work. Elementwise work, pooling and resizing are not counted."""

import functools

import numpy as np


@functools.lru_cache(maxsize=8)
def _flops(name: str, height: int, width: int) -> int:
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from core import load_json, load_module

    cfg = load_json(f"configs/{name}.json")
    ref = load_module(f"reference/{name}.py")

    def tree(leaves):
        out = {}
        for path, shape, *_ in leaves:
            node = out
            *parents, leaf = path.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = np.zeros(shape, np.float32)
        return out

    p = ref.tensors(tree(cfg["leaves"]["params"]), "meta")
    s = ref.tensors(tree(cfg["leaves"]["batch_stats"]), "meta")
    x = torch.empty((1, height, width, 3), dtype=torch.uint8, device="meta")
    with FlopCounterMode(display=False) as counter:
        ref.logits(cfg, p, s, x)
    return counter.get_total_flops()


def forward_flops(cfg: dict, height: int, width: int) -> int:
    return _flops(cfg["name"], height, width)
