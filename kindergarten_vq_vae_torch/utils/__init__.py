"""Metrics of the training step."""
