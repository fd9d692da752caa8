"""Sender gathers of the fused steps.

The sender gathers are the counterparts of
``p_div_gnn_tpu/ops/gather.py:113-150`` (``sender_gather_one``, fused3; with
fp32 inputs also ``sender_gather`` of the hybrid path, `:21-52`) and
``:58-110`` (``sender_gather_pair``, the v2 fused path).

The forward is a plain row gather ``x[senders]``. The backward of
``sender_gather_one`` permutes the (Ep, L) cotangent into the batch's
sender-major view in run order (``GraphBatch.snd_run_perm``: each tile's
slots sorted by sender, so each sender's slots are consecutive; padding
slots point at slot 0 and carry ``-1``, so they add nothing) and adds it per
sender with the block-CSR segment sum (``ops/scatter_csr.py``) into an fp32
accumulator, then casts to x's dtype.
The sums run in a fixed order, so the gradient is the same in every run,
and in bf16 stream mode it is accumulated in fp32, not bf16.

``sender_gather_pair`` gathers two node projections at once and returns
``(proj_v[senders], proj_u[senders])``; its backward sums both cotangents,
in their own dtype (the kernel widens bf16 rows as it reads them, the plain
version casts them), in one pass of the pair segment sum over the sender
view in the same run order, returning ``(d proj_u, d proj_v)`` in the order
of its inputs.

Without the sender view there is no such backward: the gathers are then
forward-only and raise when a gradient would be needed.
"""

from __future__ import annotations

import torch

from p_div_gnn_tpu_torch.ops.scatter_csr import csr_segment_sum, csr_segment_sum_pair

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


def _refuse_without_view(name: str, *xs: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        raise ValueError(
            f"{name} needs the batch's sender view for its backward "
            "(pack_batch(sender_view=True)); without it the gradient would be "
            "accumulated by index_add_ in the stream dtype"
        )


def sender_gather_one(
    x: torch.Tensor,  # (Np, L) node latents, stream dtype
    senders: torch.Tensor,  # (Ep,) i32
    view: SenderView | None = None,  # (snd_run_perm, snd_run_sorted, snd_block_tile)
    tile: int | None = None,  # node tile of the view (GraphBatch.tile)
) -> torch.Tensor:
    """``x[senders]``: one (Ep, L) stream in x's dtype, whose backward is
    the sender-view block-CSR scatter. Without ``view`` it is forward-only
    and raises if x needs a gradient."""
    if view is None:
        _refuse_without_view("sender_gather_one", x)
        return x.index_select(0, senders)
    if tile is None:
        raise ValueError("sender_gather_one: the view's node tile is required")
    return _SenderGatherOne.apply(x, senders, *view, tile)


class _SenderGatherPair(torch.autograd.Function):
    @staticmethod
    def forward(ctx, proj_u, proj_v, senders, snd_perm, snd_sorted, snd_block_tile, tile):
        ctx.save_for_backward(snd_perm, snd_sorted, snd_block_tile)
        ctx.num_nodes, ctx.tile = proj_u.shape[0], tile
        ctx.dtypes = (proj_u.dtype, proj_v.dtype)
        return proj_v.index_select(0, senders), proj_u.index_select(0, senders)

    @staticmethod
    def backward(ctx, g_v, g_u):
        # g_v is the cotangent of proj_v[snd] (first output), g_u of
        # proj_u[snd]; the gradients go back in the order (proj_u, proj_v)
        snd_perm, snd_sorted, snd_block_tile = ctx.saved_tensors
        dv, du = csr_segment_sum_pair(
            g_v.contiguous(), g_u.contiguous(), snd_sorted, snd_block_tile, ctx.num_nodes,
            ctx.tile, perm=snd_perm)
        return du.to(ctx.dtypes[0]), dv.to(ctx.dtypes[1]), None, None, None, None, None


def sender_gather_pair(
    proj_u: torch.Tensor,  # (Np, L) first-slot node projection
    proj_v: torch.Tensor,  # (Np, L) second-slot node projection
    senders: torch.Tensor,  # (Ep,) i32
    view: SenderView | None = None,  # (snd_run_perm, snd_run_sorted, snd_block_tile)
    tile: int | None = None,  # node tile of the view (GraphBatch.tile)
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(proj_v[senders], proj_u[senders])`` — the message path's and the
    edge update's sender rows — whose backward scatters both cotangents in
    one pass of the sender-view pair segment sum. Without ``view`` it is
    forward-only and raises if either projection needs a gradient."""
    if view is None:
        _refuse_without_view("sender_gather_pair", proj_u, proj_v)
        return proj_v.index_select(0, senders), proj_u.index_select(0, senders)
    if tile is None:
        raise ValueError("sender_gather_pair: the view's node tile is required")
    return _SenderGatherPair.apply(proj_u, proj_v, senders, *view, tile)

