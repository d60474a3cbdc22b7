"""PyTorch/CUDA port of ``mtg_card_image_segmentation_tpu``.

Same module layout and names as the JAX package, which stays the reference
the port is held against. This package imports ``torch`` and never JAX.
Its entry points run on the CUDA card unless the caller passes
``device="cpu"``; kernels hand-written for Hopper (``csrc/``) carry the
hot paths, each with a plain PyTorch version beside it.
"""

__version__ = "0.1.0"
