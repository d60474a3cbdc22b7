"""Checkpoints (the serving half: parameters and statistics)."""
