"""Dataset generation (counterpart of the JAX package's ``datagen/``):
scrapers for real card/HDRI/background assets (network access only through
an injected requests-like session), the crash-tolerant watchdog, and
background inpainting. The disk materializer of the on-device renderer is
``generate_dataset_torch.py``."""
