"""Scatter-add dispatch: the edge→node aggregation of the plain Processor
paths — the counterpart of ``p_div_gnn_tpu/ops/scatter.py:19-36``.

``messages`` (Ep, L) lie in the batch's receiver-major block-CSR layout;
the result is (num_nodes, L) per-node sums. ``impl="xla"`` is the plain
``segment_sum``; ``impl="pallas"`` is the block-CSR segment sum
(``ops/scatter_csr.py``: the hand-written kernel for CUDA tensors, whose TPU
counterpart is ``pallas_segment_sum``), over ``block_tile`` and ``tile``.
The receiver layout pads each tile's run onto the tile's last node with
messages that are zero downstream of the masked graph-LN, so no slot there
is −1.
"""

from __future__ import annotations

import torch

from p_div_gnn_tpu_torch.ops.scatter_csr import csr_segment_sum
from p_div_gnn_tpu_torch.ops.segment import segment_sum

SCATTER_ADD_IMPLS = ("xla", "pallas")


def scatter_add(
    messages: torch.Tensor,  # (Ep, L)
    receivers: torch.Tensor,  # (Ep,) i32, block-aligned CSR
    num_nodes: int,
    block_tile: torch.Tensor | None = None,  # (Ep / block,) i32, for "pallas"
    impl: str = "xla",
    tile: int | None = None,  # node tile of the layout, for "pallas"
) -> torch.Tensor:
    """(num_nodes, L) sums of ``messages`` over ``receivers``: in messages'
    dtype for ``"xla"``, fp32 for ``"pallas"`` (as the JAX kernel returns)."""
    if impl == "xla":
        return segment_sum(messages, receivers, num_nodes)
    if impl == "pallas":
        if block_tile is None or tile is None:
            raise ValueError("the pallas scatter needs the layout's block_tile and tile")
        return csr_segment_sum(messages, receivers, block_tile, num_nodes, tile)
    raise ValueError(f"unknown scatter impl {impl!r}, expected one of {SCATTER_ADD_IMPLS}")
