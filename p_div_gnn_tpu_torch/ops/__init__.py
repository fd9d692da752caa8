"""Tensor ops of the message-passing step and the wrappers of the
hand-written kernels (the fused3 and v2 fused edge steps' forwards and
backwards, the block-CSR segment sum and its two-stream pair)."""
