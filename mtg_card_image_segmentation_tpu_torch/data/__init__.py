"""Input preprocessing constants and helpers."""
