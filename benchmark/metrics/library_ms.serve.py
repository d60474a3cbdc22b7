"""Device time per batch of every kernel that is not built from the port's
CUDA sources (cuDNN, cuBLAS, torch's own kernels), in the traced slice.
Copies and memsets are not kernels and are left out."""

import re

from core import port_kernel_names


def read(run):
    tr = run.trace
    if tr is None or not tr.items:
        return None
    own = port_kernel_names()

    def library(name):
        if name.startswith(("Memcpy", "Memset")):
            return False
        return not own.intersection(re.findall(r"\w+", name))

    return tr.sum_us(library) * 1e-3 / len(tr.items)
