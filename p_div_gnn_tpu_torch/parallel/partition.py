"""Edge-partitioned graph execution — the counterpart of
``p_div_gnn_tpu/parallel/partition.py``.

A packed batch is split into contiguous node ranges, one per rank. Each
rank owns its range and every edge whose receiver lies in it; senders that
live elsewhere become ghosts. The host-side planner (``partition_batch``,
array-equal to the JAX planner) builds a fixed-size halo: per message-passing
step one exchange (``models/epd.py::Halo``) refreshes the ghost rows, and
edge senders and divergence-operator columns are rewritten into each rank's
extended ``[local ++ D·Hp ghost]`` address space, over which the local
batch's sender view is built, so the sender gathers' backward (#3, and #4
for ``"fused"``) runs there too and the ghost rows' cotangents flow back
through the exchange. Periodic boundary edges are the typical cut edges.

Rank r runs row r of the stacked plan (``parallel/dp.py::shard_of``) with
``Halo(send_idx[r], group)``; the loss sums its per-graph partials over the
ranks (``losses.py::partitioned_batch_loss``), so the partitioned step
reproduces the single-card one.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from p_div_gnn_tpu_torch.graphs.batching import blockify_edges, build_sender_view, pad_sender_view
from p_div_gnn_tpu_torch.graphs.container import EDGE_BLOCK, NODE_TILE, GraphBatch, NormStats
from p_div_gnn_tpu_torch.losses import partitioned_batch_loss
from p_div_gnn_tpu_torch.models.epd import Halo
from p_div_gnn_tpu_torch.parallel.collectives import Group, pmean_
from p_div_gnn_tpu_torch.parallel.dp import stack_batches


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def partition_batch(
    batch: GraphBatch,
    n_shards: int,
    tile: int = NODE_TILE,
    halo_mode: str = "a2a",
) -> tuple[GraphBatch, np.ndarray]:
    """Split a packed host batch into ``n_shards`` node-range shards.
    Returns (the local batches stacked on a leading shard axis, the halo's
    ``send_idx``: (D, D, Hp) for the per-peer ``"a2a"`` exchange, (D, H) for
    the ``"all_gather"`` union broadcast). Padding rows self-loop on the
    local padding node."""
    if halo_mode not in ("a2a", "all_gather"):
        raise ValueError(f"halo_mode {halo_mode!r} is not 'a2a' or 'all_gather'")
    Np = batch.num_nodes_padded
    per = _round_up((Np + n_shards - 1) // n_shards, tile)
    Nl = per + tile  # room for the last shard's range and a padding node
    offsets = np.arange(n_shards) * per

    senders = np.asarray(batch.senders)
    receivers = np.asarray(batch.receivers)
    node_gid = np.asarray(batch.node_gid)

    def owner(nodes: np.ndarray) -> np.ndarray:
        return np.minimum(nodes // per, n_shards - 1)

    # per-shard edge lists (the receiver's owner), one local edge capacity
    # after block alignment
    edge_lists = [np.where(owner(receivers) == d)[0] for d in range(n_shards)]
    n_tiles_l = Nl // tile
    El = 0
    for d in range(n_shards):
        l_rcv = receivers[edge_lists[d]] - offsets[d]
        counts = np.bincount(np.minimum(l_rcv // tile, n_tiles_l - 1), minlength=n_tiles_l)
        El = max(El, int((np.maximum((counts + EDGE_BLOCK - 1) // EDGE_BLOCK, 1)
                          * EDGE_BLOCK).sum()))

    # divergence entries go with their row node's owner
    div_row = np.asarray(batch.div_row)
    div_col_node = np.asarray(batch.div_col_node)
    div_lists = [np.where(owner(div_row) == d)[0] for d in range(n_shards)]
    Kl = _round_up(max(max(len(k) for k in div_lists), 1), 512)

    # need_pair[o][r]: the nodes owner o sends to requester r
    need_pair: list[list[set[int]]] = [[set() for _ in range(n_shards)]
                                       for _ in range(n_shards)]
    for d in range(n_shards):
        for arr in (senders[edge_lists[d]], div_col_node[div_lists[d]]):
            remote = arr[owner(arr) != d]
            for o in np.unique(owner(remote)):
                need_pair[int(o)][d].update(np.unique(remote[owner(remote) == o]).tolist())

    if halo_mode == "a2a":
        # tile-aligned, so the extended space stays tile-aligned for the
        # sender view
        Hp = _round_up(max(max((len(s) for row in need_pair for s in row), default=1), 1),
                       tile)
        send_idx = np.zeros((n_shards, n_shards, Hp), dtype=np.int32)
        pair_slot: list[list[dict[int, int]]] = [[{} for _ in range(n_shards)]
                                                 for _ in range(n_shards)]
        for o in range(n_shards):
            for r in range(n_shards):
                sl = np.sort(np.fromiter(need_pair[o][r], dtype=np.int64))
                send_idx[o, r, :len(sl)] = sl - offsets[o]
                pair_slot[o][r] = {int(g): i for i, g in enumerate(sl)}

        def ghost_slot(o: int, d: int, g: int) -> int:
            # the received block is (D, Hp): row o came from rank o
            return Nl + o * Hp + pair_slot[o][d][g]
    else:
        send_lists = []
        for o in range(n_shards):
            union: set[int] = set().union(*need_pair[o])
            send_lists.append(np.sort(np.fromiter(union, dtype=np.int64)))
        H = _round_up(max(max((len(s) for s in send_lists), default=1), 1), tile)
        send_idx = np.zeros((n_shards, H), dtype=np.int32)
        slot_of: list[dict[int, int]] = []
        for o, sl in enumerate(send_lists):
            send_idx[o, :len(sl)] = sl - offsets[o]
            slot_of.append({int(g): i for i, g in enumerate(sl)})

        def ghost_slot(o: int, d: int, g: int) -> int:
            return Nl + o * H + slot_of[o][g]

    def ext_addr(global_nodes: np.ndarray, d: int) -> np.ndarray:
        """Global node ids in shard d's extended address space."""
        own = owner(global_nodes)
        out = np.empty(len(global_nodes), dtype=np.int32)
        mine = own == d
        out[mine] = (global_nodes - offsets[d])[mine]
        for o in np.unique(own[~mine]):
            sel = (own == o) & ~mine
            out[sel] = np.array([ghost_slot(int(o), d, int(g)) for g in global_nodes[sel]],
                                dtype=np.int32)
        return out

    n_ext = Nl + n_shards * send_idx.shape[-1]  # D·Hp (a2a) or D·H ghost rows
    G = batch.n_graphs
    shards = []
    for d in range(n_shards):
        lo = offsets[d]
        hi = max(lo, min(lo + per, Np))  # a shard past Np owns nothing
        n_here = hi - lo

        def node_arr(a, fill=0.0):
            a = np.asarray(a)
            out = np.full((Nl,) + a.shape[1:], fill, dtype=a.dtype)
            out[:n_here] = a[lo:hi]
            return out

        l_gid = np.full(Nl, G, np.int32)
        l_gid[:n_here] = node_gid[lo:hi]
        e_idx = edge_lists[d]
        raw_snd = ext_addr(senders[e_idx], d) if len(e_idx) else np.zeros(0, np.int32)
        raw_rcv = (receivers[e_idx] - lo).astype(np.int32)
        order = np.argsort(raw_rcv, kind="stable")
        l_snd, l_rcv, l_ew, l_eg, l_tp, l_bt = blockify_edges(
            raw_snd[order].astype(np.int32), raw_rcv[order],
            np.asarray(batch.edge_weight)[e_idx][order], np.asarray(batch.edge_gid)[e_idx][order],
            num_nodes=Nl, n_graphs=G, tile=tile, min_capacity=El,
        )
        # the sender view over the extended rows
        l_sp, l_ss, l_sbt = build_sender_view(l_snd, n_ext, tile)

        k_idx = div_lists[d]
        k = len(k_idx)
        l_dd = np.zeros(Kl, np.float32)
        l_dr = np.full(Kl, Nl - 1, np.int32)
        l_dc = np.full(Kl, Nl - 1, np.int32)
        l_dy = np.zeros(Kl, np.int32)
        l_dd[:k] = np.asarray(batch.div_data)[k_idx]
        l_dr[:k] = div_row[k_idx] - lo
        l_dc[:k] = ext_addr(div_col_node[k_idx], d)
        l_dy[:k] = np.asarray(batch.div_col_is_y)[k_idx]

        # local per-graph node counts (the loss sums them over the ranks)
        counts = np.zeros(G, np.int32)
        ids, c = np.unique(l_gid[l_gid < G], return_counts=True)
        counts[ids] = c

        shards.append(GraphBatch(
            pos=node_arr(batch.pos),
            mean_stress=node_arr(batch.mean_stress),
            node_type=node_arr(batch.node_type),
            local_stress=node_arr(batch.local_stress),
            node_gid=l_gid,
            senders=l_snd, receivers=l_rcv, edge_weight=l_ew, edge_gid=l_eg,
            tile_ptr=l_tp, edge_block_tile=l_bt,
            div_data=l_dd, div_row=l_dr, div_col_node=l_dc, div_col_is_y=l_dy,
            graph_node_count=counts,
            graph_node_offset=np.zeros(G, np.int32),
            n_graphs=G, tile=tile,
            snd_perm=l_sp, snd_sorted=l_ss, snd_block_tile=l_sbt,
        ))
    # one sender-view capacity for every shard
    vcap = max(len(b.snd_perm) for b in shards)
    for b in shards:
        b.snd_perm, b.snd_sorted, b.snd_block_tile = pad_sender_view(
            b.snd_perm, b.snd_sorted, b.snd_block_tile, vcap, n_ext, tile)
    return stack_batches(shards), send_idx


def make_partitioned_forward(
    model: torch.nn.Module, stats: NormStats, group: Group, scale_output: bool = True,
) -> Callable[[GraphBatch, Halo], torch.Tensor]:
    """``forward(local_batch, halo)``: this rank's (Nl, 3) prediction."""

    @torch.no_grad()
    def forward(batch: GraphBatch, halo: Halo) -> torch.Tensor:
        return model(batch, stats, scale_input=True, scale_output=scale_output,
                     group=group, halo=halo)

    return forward


def make_partitioned_train_step(
    model: torch.nn.Module,
    stats: NormStats,
    optimizer: torch.optim.Optimizer,
    group: Group,
    divergence_penalty: float = 0.0,
    optimize_divergence: bool = False,
) -> Callable[[GraphBatch, Halo], dict[str, torch.Tensor]]:
    """``step(local_batch, halo)``: the halo-exchanged forward, the whole
    batch's loss, the backward, the gradients' mean over the ranks (the
    contract of ``parallel/dp.py``) and the replicated Adam update; returns
    the loss terms (the same on every rank)."""

    def step(batch: GraphBatch, halo: Halo) -> dict[str, torch.Tensor]:
        model.zero_grad(set_to_none=True)
        pred = model(batch, stats, scale_input=True, scale_output=False, group=group,
                     halo=halo)
        gt = (batch.local_stress - stats.mean_local_stress) / stats.std_local_stress
        total, aux = partitioned_batch_loss(batch, pred, gt, halo, group,
                                            divergence_penalty, optimize_divergence)
        total.backward()
        pmean_([p.grad for p in model.parameters()], group)
        optimizer.step()
        return {**{k: v.detach() for k, v in aux.items()}, "total": total.detach()}

    return step
