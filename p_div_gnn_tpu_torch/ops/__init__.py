"""Tensor ops of the message-passing step and the wrappers of the
hand-written kernels (fused edge step forward and backward, block-CSR
segment sum)."""
