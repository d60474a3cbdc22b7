"""The work of the dilated tail (blocks 12-14 of ``seg-mnv3l-lraspp``) on a
batch, counted from the problem's shapes: the tail's input (block 11's
width) read once and its output written once, in bf16, and its weights
(bf16 kernels, float32 biases) read once; the 1x1 expand and project
products on the tensor cores, the depthwise taps and the SE unit's products
on the CUDA cores, 2 operations per multiply-add. Its kernels are the four
block kernels (expand GEMM, depthwise, SE gate, project GEMM) of the
port's chain."""

from shapes import down, make_divisible, token_in

KERNELS = ("pw_gemm_kernel", "depthwise_kernel", "se_gate_kernel")
TAIL = (12, 13, 14)


def ran(name: str) -> bool:
    return token_in(name, KERNELS)


def count(cell: dict, cfg: dict):
    """(bytes, tensor-core operations, CUDA-core operations) per batch."""
    tp = cell["traffic_params"]
    b = tp["batch"]
    m = b * down(tp["height"], 4) * down(tp["width"], 4)
    rows = cfg["rows"]
    cin0 = rows[TAIL[0] - 1][2]
    tensor = fp32 = wbytes = 0
    cin = cin0
    for i in TAIL:
        k, exp, out, se, _act, _stride, _dil = rows[i]
        sq = make_divisible(exp // 4, cfg["se_divisor"])
        tensor += 2 * m * exp * (cin + out)
        fp32 += 2 * m * k * k * exp + (4 * b * exp * sq if se else 0)
        wbytes += 2 * (cin * exp + k * k * exp + exp * out + (2 * exp * sq if se else 0))
        wbytes += 4 * (exp + exp + out + (sq + exp if se else 0))
        cin = out
    return m * (cin0 + cin) * 2 + wbytes, tensor, fp32
