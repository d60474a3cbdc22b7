"""Inference-time parameter transforms."""
