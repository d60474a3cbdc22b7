"""Batched segmentation serving on the card."""
