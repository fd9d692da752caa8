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

Sharded execution (``forward(..., group=, halo=)``, the JAX package's
``axis_name`` and ``halo``): under data parallelism (``group``) every
graph-LN (the encoders', the edge LN's moments, the node LN) takes the
whole batch's statistics over the group's ranks, and so does the zero
early exit. Under edge partitioning (``halo``, ``parallel/partition.py``)
each rank holds a node range and the edges into it; senders address the
extended ``[local ++ D·Hp ghost]`` rows, refreshed by one exchange per
message-passing step (``Halo``): ``"xla"`` / ``"pallas"`` / ``"hybrid"`` /
``"fused"`` issue the exchange of the raw node latents before their local
projections and wait where the ghost rows are first projected;
``"fused3"`` sends its ghosts in the stream dtype and gathers ``x_ext``
through the sender view built over the extended rows; ``"fused2"`` is
single-shard and raises under a halo. With remat the backward re-runs each
step's exchange and all-reduces; every rank runs the same steps in the same
order, so the collectives stay matched.

The JAX package runs fp32 at HIGHEST precision unless
``PDG_MATMUL_PRECISION`` names another; importing this module applies that
policy to torch's fp32 products (``utils/precision.py``): by default TF32 is
off for matmuls and convolutions.
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
from p_div_gnn_tpu_torch.parallel.collectives import (
    Group,
    psum,
    start_all_gather,
    start_all_to_all,
)
from p_div_gnn_tpu_torch.utils.precision import matmul_precision

matmul_precision()

SCATTER_IMPLS = ("xla", "pallas", "hybrid", "fused", "fused2", "fused3")
FUSED_IMPLS = ("fused", "fused2", "fused3")
# node features [σ̄xx, σ̄yy, σ̄xy, pos_x, pos_y, node_type], edge feature
# [distance], output [σxx, σyy, σxy]
NODE_FEATURES, EDGE_FEATURES, OUT_FEATURES = 6, 1, 3
STREAM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Halo:
    """Ghost-node exchange plan of edge-partitioned execution (the JAX
    ``Halo``, ``models/epd.py:50-104``). Each rank owns a node range; an
    edge lives with its receiver's owner, and its sender may be a remote
    node, addressed in the extended space ``[local 0..Nl) ++ ghosts``. Two
    wire formats, chosen by the planner through ``send_idx``'s rank:

    - ``(H,)`` all-gather: every rank publishes the union of its nodes any
      peer needs; node g owned by o is ghost row ``Nl + o·H + s``;
    - ``(D, Hp)`` all-to-all: row r lists the nodes this rank sends to rank
      r; ghost row ``Nl + o·Hp + s``, s the slot in the (o → me) list.
    """

    def __init__(self, send_idx: torch.Tensor, group: Group):
        self.send_idx = send_idx.long()
        self.group = group

    def start_exchange(self, x_local: torch.Tensor):
        """Issue the exchange of ``x_local``'s published rows; returns a
        function that waits for it and gives the (D·H[p], C) ghost rows."""
        buf = x_local[self.send_idx]
        if self.send_idx.dim() == 2:
            pending = start_all_to_all(buf, self.group)
        else:
            pending = start_all_gather(buf, self.group)
        return lambda: pending.wait().flatten(0, 1)

    def exchange_ghosts(self, x_local: torch.Tensor) -> torch.Tensor:
        return self.start_exchange(x_local)()

    def exchange(self, x_local: torch.Tensor) -> torch.Tensor:
        """``[x_local ++ ghosts]``: rows in the extended address space."""
        return torch.cat([x_local, self.exchange_ghosts(x_local)])


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
        group: Group | None = None,  # ranks whose statistics are summed
        halo: Halo | None = None,  # ghost exchange of edge partitioning
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
        if halo is not None and self.scatter_impl == "fused2":
            raise ValueError("scatter_impl='fused2' is single-shard: it takes no halo")
        if self.scatter_impl != "fused3":
            # the node projections; under a halo the raw ghost rows are in
            # flight while the local ones are projected
            wait_ghosts = halo.start_exchange(x) if halo is not None else None
            proj_u = x @ self.edge_w_u  # FIRST slot
            proj_v = x @ self.edge_w_v  # SECOND slot
            e_proj = None if self.scatter_impl in FUSED_IMPLS else e @ self.edge_w_e
            if wait_ghosts is not None:
                ghosts = wait_ghosts()
                proj_u = torch.cat([proj_u, ghosts @ self.edge_w_u])
                proj_v = torch.cat([proj_v, ghosts @ self.edge_w_v])
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
                # ghosts travel in the stream dtype
                x_ext = x_sd if halo is None else halo.exchange(x_sd)
                g_x = sender_gather_one(x_ext, snd, view, batch.tile)
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
                aux2 = aux + (batch.edge_block_snd_tile,) + (view or ())
                z_upd, r_raw, m = fused_edge_step2(
                    proj_u.to(sd), proj_v.to(sd), e.to(sd), w_e, b0, lin_w, lin_b, rcv, snd,
                    aux2, batch.n_graphs, batch.tile,
                )
            else:
                # under a halo the projections span the extended rows, and
                # the kernel takes the local ones
                g_v, g_u = sender_gather_pair(proj_u, proj_v, snd, view, batch.tile)
                z_upd, r_raw, m = fused_edge_step(
                    proj_u[:Np].to(sd), proj_v[:Np].to(sd), g_v.to(sd), g_u.to(sd), e.to(sd),
                    w_e, b0, lin_w, lin_b, rcv, aux, batch.n_graphs, batch.tile,
                )
            a1, b1 = lazy_layernorm_affine(
                *moments_from_partials(m[0], m[1], edge_mask, group), ln_w, ln_b
            )
            a2, b2 = lazy_layernorm_affine(
                *moments_from_partials(m[2], m[3], edge_mask, group), ln_w, ln_b
            )
            if deg is None:
                deg = segment_sum(edge_mask.float()[:, None], rcv, Np)
            aggr = r_raw * a1 + deg * b1
            new_e = (z_upd * a2 + b2) * edge_mask[:, None]
        else:
            def edge_net_tail(pre: torch.Tensor) -> torch.Tensor:
                y = torch.relu(self.edge_lin1(torch.relu(pre)))
                return masked_graph_layernorm(y, edge_mask, ln_w, ln_b, group=group)

            def gather_snd(p: torch.Tensor) -> torch.Tensor:
                if self.scatter_impl == "hybrid" and view is not None:
                    return sender_gather_one(p, snd, view, batch.tile)
                return p[snd]

            # message: edge_net([x_i, x_j, e]) with i = target, j = source;
            # e_proj is shared by both evaluations
            messages = edge_net_tail(proj_u[rcv] + gather_snd(proj_v) + e_proj + self.edge_b0)
            # edge update: edge_net([x_source, x_target, e])
            new_e = edge_net_tail(gather_snd(proj_u) + proj_v[rcv] + e_proj + self.edge_b0)
            aggr = scatter_add(
                messages, rcv, Np, batch.edge_block_tile,
                impl="pallas" if self.scatter_impl == "pallas" else "xla", tile=batch.tile,
            )
        node_pre = aggr @ self.node_w_a + x @ self.node_w_x + self.node_b0
        node_h = torch.relu(node_pre)
        new_x = self.node_ln(torch.relu(self.node_lin1(node_h)), batch.node_mask, group)
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
        group: Group | None = None,
        halo: Halo | None = None,
    ) -> torch.Tensor:
        """(Np, 3) stress field; standardized when ``scale_output`` is False.
        ``scale_input`` standardizes the node and edge features. ``group``
        and ``halo``: sharded execution (module docstring); ``batch`` is then
        this rank's shard and the result its rows."""
        mean_stress, pos, e_in = batch.mean_stress, batch.pos, batch.edge_weight
        if scale_input:
            mean_stress = (mean_stress - stats.mean_mean_stress) / stats.std_mean_stress
            pos = (pos - stats.mean_pos) / stats.std_pos
            e_in = (e_in - stats.mean_edge_weight) / stats.std_edge_weight
        x_in = torch.cat([mean_stress, pos, batch.node_type], dim=-1)
        x = self.node_encoder(x_in, batch.node_mask, group)
        e = self.edge_encoder(e_in, batch.edge_mask, group)
        # the lazy-LN fold's per-node real in-degree is the same every step
        deg = None
        if self.scatter_impl in FUSED_IMPLS:
            deg = segment_sum(batch.edge_mask.float()[:, None], batch.receivers, x.shape[0])
        remat = self.remat_steps and torch.is_grad_enabled()
        for _ in range(self.message_passing_steps):
            if remat:
                x, e = checkpoint(self.processor, x, e, batch, deg, group, halo,
                                  use_reentrant=False)
            else:
                x, e = self.processor(x, e, batch, deg, group, halo)
        decoded = self.node_decoder(x)
        if scale_output:
            decoded = decoded * stats.std_local_stress + stats.mean_local_stress
        # zero early exit (`models.py:294-299`): an all-zero macroscopic
        # stress gives a zero field (batch-level check, like the reference;
        # summed over the ranks, so all shards agree)
        any_nonzero = psum(torch.any(batch.mean_stress != 0).int(), group) > 0
        return torch.where(any_nonzero, decoded, torch.zeros_like(decoded))
