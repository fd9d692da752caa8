"""Checkpoint reading (the training loop is not ported yet)."""
