"""Structured pruning and physical channel removal."""
