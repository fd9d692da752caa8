"""Tensor ops of the message-passing step and the fused edge-step kernel."""
