"""Segmentation training: optimizer and schedules, train state, train/eval
steps, BatchNorm recalibration, checkpoints and the epoch loop."""
