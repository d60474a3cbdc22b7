"""The work of the mask decode on a batch, from the shapes: the float32
card-minus-background score at stride 8 read once, the uint8 mask written
once; a row lerp of every source column for every output row, then a
column lerp of every output pixel (3 operations each)."""

from shapes import down, token_in

KERNELS = ("mask_decode_kernel",)


def ran(name: str) -> bool:
    return token_in(name, KERNELS)


def count(cell: dict, cfg: dict):
    tp = cell["traffic_params"]
    b, h, w = tp["batch"], tp["height"], tp["width"]
    h8, w8 = down(h, 3), down(w, 3)
    return b * h8 * w8 * 4 + b * h * w, 0, 3 * b * h * (w8 + w)
