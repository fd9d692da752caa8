"""Checkpoint reading and the training step."""
