"""Model FLOPs of the traced slice's images (2 per multiply-add of every
conv and product, counted from the configuration's shapes by
``work/<config>.py``) over the slice's seconds and the card's bf16 tensor
peak."""

from peaks import BF16_TENSOR_FLOPS


def read(run):
    tr = run.trace
    if tr is None or not tr.items:
        return None
    tp = run.cell["traffic_params"]
    flops = run.work(f"work/{run.cfg['name']}.py").forward_flops(run.cfg, tp["height"], tp["width"])
    return 100.0 * flops * tr.images / tr.window_s / BF16_TENSOR_FLOPS
