"""Wrappers of the CUDA kernels in ``csrc/``, one module per Pallas source
file of the JAX package (``ops/pallas/``), each with its plain version."""
