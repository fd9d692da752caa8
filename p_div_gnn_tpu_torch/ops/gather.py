"""Sender gather of the fused3 step — the forward of
``p_div_gnn_tpu/ops/gather.py:113-136`` (``sender_gather_one``).

The forward is a plain row gather. The JAX package's custom backward (a
permute into the sender-major view and the block-CSR scatter kernel) comes
with the training slice.
"""

from __future__ import annotations

import torch


def sender_gather_one(x: torch.Tensor, senders: torch.Tensor) -> torch.Tensor:
    """``x[senders]``: one (Ep, L) stream in x's dtype."""
    return x.index_select(0, senders)
