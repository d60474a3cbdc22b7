"""The work of the input normalize on a batch, from the shapes: uint8 in,
bf16 out, a multiply and an add per value."""

from shapes import token_in

KERNELS = ("normalize_kernel",)


def ran(name: str) -> bool:
    return token_in(name, KERNELS)


def count(cell: dict, cfg: dict):
    tp = cell["traffic_params"]
    n = tp["batch"] * tp["height"] * tp["width"] * 3
    return 3 * n, 0, 2 * n
