"""Tensor ops; ``ops.kernels`` holds the hand-written CUDA kernels."""
