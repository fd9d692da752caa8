"""Sender gather of the fused3 step — the counterpart of
``p_div_gnn_tpu/ops/gather.py:113-150`` (``sender_gather_one``).

The forward is a plain row gather ``x[senders]``. The backward permutes the
(Ep, L) cotangent into the batch's sender-major view (``snd_perm``; padding
slots point at slot 0 and carry ``snd_sorted == -1``, so they add nothing)
and adds it per sender with the block-CSR segment sum
(``ops/scatter_csr.py``) into an fp32 accumulator, then casts to x's dtype.
The sums run in a fixed order, so the gradient is the same in every run,
and in bf16 stream mode it is accumulated in fp32, not bf16.

Without the sender view there is no such backward: the gather is then
forward-only and raises when a gradient would be needed.
"""

from __future__ import annotations

import torch

from p_div_gnn_tpu_torch.ops.scatter_csr import csr_segment_sum

SenderView = tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # perm, sorted, block_tile


class _SenderGatherOne(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, senders, snd_perm, snd_sorted, snd_block_tile, tile):
        ctx.save_for_backward(snd_perm, snd_sorted, snd_block_tile)
        ctx.num_nodes, ctx.tile = x.shape[0], tile
        return x.index_select(0, senders)

    @staticmethod
    def backward(ctx, g):
        snd_perm, snd_sorted, snd_block_tile = ctx.saved_tensors
        dx = csr_segment_sum(g, snd_sorted, snd_block_tile, ctx.num_nodes, ctx.tile,
                             perm=snd_perm)
        return dx.to(g.dtype), None, None, None, None, None


def sender_gather_one(
    x: torch.Tensor,  # (Np, L) node latents, stream dtype
    senders: torch.Tensor,  # (Ep,) i32
    view: SenderView | None = None,  # (snd_perm, snd_sorted, snd_block_tile)
    tile: int | None = None,  # node tile of the view (GraphBatch.tile)
) -> torch.Tensor:
    """``x[senders]``: one (Ep, L) stream in x's dtype, whose backward is
    the sender-view block-CSR scatter. Without ``view`` it is forward-only
    and raises if x needs a gradient."""
    if view is None:
        if torch.is_grad_enabled() and x.requires_grad:
            raise ValueError(
                "sender_gather_one needs the batch's sender view for its backward "
                "(pack_batch(sender_view=True)); without it the gradient would be "
                "accumulated by index_add_ in the stream dtype"
            )
        return x.index_select(0, senders)
    if tile is None:
        raise ValueError("sender_gather_one: the view's node tile is required")
    return _SenderGatherOne.apply(x, senders, *view, tile)
