"""EncodeProcessDecode — the P-DivGNN model, in torch.nn.

Counterpart of ``p_div_gnn_tpu/models/epd.py:99-526``
(reference `models.py:98-326`): node features
``[σ̄xx, σ̄yy, σ̄xy, pos_x, pos_y, node_type]`` with scalar standardisation,
encoders 6→L and 1→L, ONE Processor shared across all message-passing steps,
decoder L→L→3, and the zero early exit when the macroscopic stress is all
zero.

The Processor's edge MLP first layer over the concat ``[u, v, e]`` is split
per slot (``edge_w_u``, ``edge_w_v``, ``edge_w_e``), as in the JAX package.
Implementations of the step (``scatter_impl``), each the counterpart of the
JAX package's impl of the same name:

- ``"xla"``: the plain path (`epd.py:346-392`) — node projections, gathers,
  two edge-MLP tails with graph-LN, ``segment_sum`` over receivers;
- ``"pallas"``: the plain path with the receiver scatter on the block-CSR
  segment sum (``ops/scatter.py``; kernel ``csrc/segment_sum_csr.cu``);
- ``"hybrid"``: the plain path whose two sender gathers take the
  sender-view backward of ``ops/gather.py`` (block-CSR segment sum) when the
  batch has the sender view;
- ``"fused"``: the v2 fused path (`epd.py:282-344`) — node projections
  x·Wu and x·Wv, both sender gathers in one pair (``sender_gather_pair``,
  whose backward is the pair segment sum over the sender view), the v2
  fused edge-step kernels (``ops/fused_edge.py``), and the graph-LN folded
  lazily into its consumers;
- ``"fused2"``: the pair-blocked fused path (`epd.py:238-281`) — node
  projections x·Wu and x·Wv as in ``"xla"``, then one edge-step kernel that
  gathers both endpoints and projects e itself (``fused_edge_step2``, on a
  batch packed with ``pair_blocks=True``), and the graph-LN folded lazily
  into its consumers; its backward adds the sender-side cotangents with the
  pair segment sum over the batch's sender view;
- ``"fused3"``: the fused path (`epd.py:182-237`) — one sender gather of x in
  the stream dtype (``ops/gather.py``, whose backward is the block-CSR
  scatter over the batch's sender view), the fused edge-step kernels
  (``ops/fused_edge3.py``), and the graph-LN folded lazily into its
  consumers: ``aggr = R·α1 + deg·β1``, ``new_e = (z_upd·α2 + β2)·mask``.

Every sender gather reads the batch's sender view in run order
(``GraphBatch.snd_run_perm`` / ``snd_run_sorted``, made by
``GraphBatch.to``): the block-CSR segment sum kernel needs each sender's
slots consecutive. On the card, "pallas" and the fused3 backward need the
receiver-major layout, whose receivers are consecutive too: their kernels
raise on a pair-blocked batch (the plain versions on the CPU take it).

Training the fused paths needs the sender view
(``pack_batch(sender_view=True)``); without it the step raises rather than
accumulate the gathers' gradient in the stream dtype.

With ``remat_steps`` (the JAX default) each message-passing step is
rematerialized in the backward (``torch.utils.checkpoint``): only the
(x, e) carries are kept per step.

The JAX package runs fp32 at HIGHEST precision, so importing this module
turns TF32 off for matmuls and convolutions.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from p_div_gnn_tpu_torch.graphs.container import NODE_TILE, GraphBatch, NormStats
from p_div_gnn_tpu_torch.models.blocks import (
    GraphLayerNorm,
    MLPBlock,
    TorchDense,
    uniform_param,
)
from p_div_gnn_tpu_torch.ops.fused_edge import (
    fused_edge_step,
    fused_edge_step2,
    lazy_layernorm_affine,
    moments_from_partials,
)
from p_div_gnn_tpu_torch.ops.fused_edge3 import fused_edge_step3
from p_div_gnn_tpu_torch.ops.gather import sender_gather_one, sender_gather_pair
from p_div_gnn_tpu_torch.ops.layernorm import masked_graph_layernorm
from p_div_gnn_tpu_torch.ops.scatter import scatter_add
from p_div_gnn_tpu_torch.ops.segment import segment_sum

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SCATTER_IMPLS = ("xla", "pallas", "hybrid", "fused", "fused2", "fused3")
FUSED_IMPLS = ("fused", "fused2", "fused3")
# node features [σ̄xx, σ̄yy, σ̄xy, pos_x, pos_y, node_type], edge feature
# [distance], output [σxx, σyy, σxy]
NODE_FEATURES, EDGE_FEATURES, OUT_FEATURES = 6, 1, 3
STREAM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Processor(nn.Module):
    """One message-passing step (reference `Processor`, models.py:182-243)."""

    def __init__(
        self,
        latent_size: int,
        generator: torch.Generator,
        scatter_impl: str = "xla",
        stream_dtype: str = "float32",
    ):
        super().__init__()
        if scatter_impl not in SCATTER_IMPLS:
            raise ValueError(f"scatter_impl {scatter_impl!r} not in {SCATTER_IMPLS}")
        L = latent_size
        self.scatter_impl = scatter_impl
        self.stream_dtype = STREAM_DTYPES[stream_dtype]
        # init bounds use the CONCAT fan-in (3L for [u, v, e], 2L for
        # [aggr, x]), as torch's Linear over the full concat would
        bound = 1.0 / math.sqrt(3 * L)
        self.edge_w_u = uniform_param((L, L), bound, generator)
        self.edge_w_v = uniform_param((L, L), bound, generator)
        self.edge_w_e = uniform_param((L, L), bound, generator)
        self.edge_b0 = uniform_param((L,), bound, generator)
        self.edge_lin1 = TorchDense(L, L, generator)
        self.edge_ln = GraphLayerNorm(L)
        nbound = 1.0 / math.sqrt(2 * L)
        self.node_w_a = uniform_param((L, L), nbound, generator)
        self.node_w_x = uniform_param((L, L), nbound, generator)
        self.node_b0 = uniform_param((L,), nbound, generator)
        self.node_lin1 = TorchDense(L, L, generator)
        self.node_ln = GraphLayerNorm(L)

    def forward(
        self,
        x: torch.Tensor,  # (Np, L) node latents
        e: torch.Tensor,  # (Ep, L) edge latents
        batch: GraphBatch,
        deg: torch.Tensor | None = None,  # (Np, 1) real in-degree (hoisted)
    ) -> tuple[torch.Tensor, torch.Tensor]:
        snd, rcv = batch.senders, batch.receivers
        edge_mask = batch.edge_mask
        ln_w, ln_b = self.edge_ln.weight, self.edge_ln.bias
        Np = x.shape[0]
        # the sender gathers read the sender view in run order (GraphBatch.to)
        view = None
        if batch.snd_perm is not None:
            if batch.snd_run_perm is None:
                raise ValueError("the batch's sender view has no run order: move the "
                                 "batch to its device with GraphBatch.to")
            view = (batch.snd_run_perm, batch.snd_run_sorted, batch.snd_block_tile)
        if self.scatter_impl in FUSED_IMPLS:
            # the kernels address node tiles of the batch's layout
            if batch.tile != NODE_TILE:
                raise ValueError(
                    f"batch packed with tile={batch.tile}, the {self.scatter_impl} path "
                    f"runs the layout's NODE_TILE={NODE_TILE}; repack the batch"
                )
            sd = self.stream_dtype
            aux = (batch.edge_gid, batch.edge_block_tile)
            w_e, b0 = self.edge_w_e.to(sd), self.edge_b0.to(sd)
            lin_w, lin_b = self.edge_lin1.kernel.to(sd), self.edge_lin1.bias.to(sd)
            if self.scatter_impl == "fused3":
                x_sd = x.to(sd)
                g_x = sender_gather_one(x_sd, snd, view, batch.tile)
                z_upd, r_raw, m = fused_edge_step3(
                    x_sd, g_x, e.to(sd), self.edge_w_u.to(sd), self.edge_w_v.to(sd), w_e, b0,
                    lin_w, lin_b, rcv, aux, batch.n_graphs, batch.tile,
                )
            elif self.scatter_impl == "fused2":
                if batch.edge_block_snd_tile is None:
                    raise ValueError(
                        "scatter_impl='fused2' needs pair-blocked batches "
                        "(pack_batch(pair_blocks=True))"
                    )
                proj_u = x @ self.edge_w_u  # FIRST slot
                proj_v = x @ self.edge_w_v  # SECOND slot
                aux2 = aux + (batch.edge_block_snd_tile,) + (view or ())
                z_upd, r_raw, m = fused_edge_step2(
                    proj_u.to(sd), proj_v.to(sd), e.to(sd), w_e, b0, lin_w, lin_b, rcv, snd,
                    aux2, batch.n_graphs, batch.tile,
                )
            else:
                proj_u = x @ self.edge_w_u  # FIRST slot
                proj_v = x @ self.edge_w_v  # SECOND slot
                g_v, g_u = sender_gather_pair(proj_u, proj_v, snd, view, batch.tile)
                z_upd, r_raw, m = fused_edge_step(
                    proj_u.to(sd), proj_v.to(sd), g_v.to(sd), g_u.to(sd), e.to(sd), w_e, b0,
                    lin_w, lin_b, rcv, aux, batch.n_graphs, batch.tile,
                )
            a1, b1 = lazy_layernorm_affine(
                *moments_from_partials(m[0], m[1], edge_mask), ln_w, ln_b
            )
            a2, b2 = lazy_layernorm_affine(
                *moments_from_partials(m[2], m[3], edge_mask), ln_w, ln_b
            )
            if deg is None:
                deg = segment_sum(edge_mask.float()[:, None], rcv, Np)
            aggr = r_raw * a1 + deg * b1
            new_e = (z_upd * a2 + b2) * edge_mask[:, None]
        else:
            proj_u = x @ self.edge_w_u  # FIRST slot
            proj_v = x @ self.edge_w_v  # SECOND slot
            e_proj = e @ self.edge_w_e  # shared by both evaluations

            def edge_net_tail(pre: torch.Tensor) -> torch.Tensor:
                y = torch.relu(self.edge_lin1(torch.relu(pre)))
                return masked_graph_layernorm(y, edge_mask, ln_w, ln_b)

            def gather_snd(p: torch.Tensor) -> torch.Tensor:
                if self.scatter_impl == "hybrid" and view is not None:
                    return sender_gather_one(p, snd, view, batch.tile)
                return p[snd]

            # message: edge_net([x_i, x_j, e]) with i = target, j = source
            messages = edge_net_tail(proj_u[rcv] + gather_snd(proj_v) + e_proj + self.edge_b0)
            # edge update: edge_net([x_source, x_target, e])
            new_e = edge_net_tail(gather_snd(proj_u) + proj_v[rcv] + e_proj + self.edge_b0)
            aggr = scatter_add(
                messages, rcv, Np, batch.edge_block_tile,
                impl="pallas" if self.scatter_impl == "pallas" else "xla", tile=batch.tile,
            )
        node_pre = aggr @ self.node_w_a + x @ self.node_w_x + self.node_b0
        node_h = torch.relu(node_pre)
        new_x = self.node_ln(torch.relu(self.node_lin1(node_h)), batch.node_mask)
        return new_x + x, new_e + e


class EncodeProcessDecode(nn.Module):
    """Encode-process-decode stress-field model (models.py:246-326)."""

    def __init__(
        self,
        latent_size: int = 128,
        message_passing_steps: int = 10,
        scatter_impl: str = "xla",
        stream_dtype: str = "float32",
        generator: torch.Generator | None = None,
        remat_steps: bool = True,
    ):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        L = latent_size
        self.latent_size = latent_size
        self.message_passing_steps = message_passing_steps
        self.remat_steps = remat_steps
        self.scatter_impl = scatter_impl
        self.stream_dtype = stream_dtype
        self.node_encoder = MLPBlock(NODE_FEATURES, L, generator)
        self.edge_encoder = MLPBlock(EDGE_FEATURES, L, generator)
        self.processor = Processor(L, generator, scatter_impl, stream_dtype)
        self.node_decoder = MLPBlock(
            L, L, generator, out_size=OUT_FEATURES, layer_norm=False
        )

    def forward(
        self,
        batch: GraphBatch,
        stats: NormStats,
        scale_input: bool = True,
        scale_output: bool = True,
    ) -> torch.Tensor:
        """(Np, 3) stress field; standardized when ``scale_output`` is False.
        ``scale_input`` standardizes the node and edge features."""
        mean_stress, pos, e_in = batch.mean_stress, batch.pos, batch.edge_weight
        if scale_input:
            mean_stress = (mean_stress - stats.mean_mean_stress) / stats.std_mean_stress
            pos = (pos - stats.mean_pos) / stats.std_pos
            e_in = (e_in - stats.mean_edge_weight) / stats.std_edge_weight
        x_in = torch.cat([mean_stress, pos, batch.node_type], dim=-1)
        x = self.node_encoder(x_in, batch.node_mask)
        e = self.edge_encoder(e_in, batch.edge_mask)
        # the lazy-LN fold's per-node real in-degree is the same every step
        deg = None
        if self.scatter_impl in FUSED_IMPLS:
            deg = segment_sum(batch.edge_mask.float()[:, None], batch.receivers, x.shape[0])
        remat = self.remat_steps and torch.is_grad_enabled()
        for _ in range(self.message_passing_steps):
            if remat:
                x, e = checkpoint(self.processor, x, e, batch, deg, use_reentrant=False)
            else:
                x, e = self.processor(x, e, batch, deg)
        decoded = self.node_decoder(x)
        if scale_output:
            decoded = decoded * stats.std_local_stress + stats.mean_local_stress
        # zero early exit (`models.py:294-299`): an all-zero macroscopic
        # stress gives a zero field (batch-level check, like the reference)
        return torch.where(
            torch.any(batch.mean_stress != 0), decoded, torch.zeros_like(decoded)
        )
