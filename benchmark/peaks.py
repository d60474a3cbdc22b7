"""The published peaks of one NVIDIA H100 SXM (dense rates, 700 W) and the
least time a piece of work can take on it (frozen from the repository's
smoke script, ``chip_smoke.py::bound``)."""

HBM_BYTES_PER_S = 3.35e12   # HBM3
BF16_TENSOR_FLOPS = 989e12  # dense bf16 on the tensor cores
FP32_FLOPS = 67e12          # fp32 outside the tensor cores


def bound_s(nbytes: float, tensor_flops: float = 0.0, fp32_flops: float = 0.0):
    """(seconds, "bytes" | "operations"): the larger of the bytes over the
    HBM rate and the operations over their unit's peak (tensor cores and
    CUDA cores run side by side, so the slower of the two)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(tensor_flops / BF16_TENSOR_FLOPS, fp32_flops / FP32_FLOPS)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
