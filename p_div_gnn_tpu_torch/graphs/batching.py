"""Pack host mesh-graph samples into static-shape padded GraphBatches (numpy).

Copy of ``p_div_gnn_tpu/graphs/batching.py``: RCM node reordering, the
block-aligned CSR edge layout (receiver-major, or pair-blocked by (receiver
tile, sender tile) for the ``fused2`` path), the sender-major view and the
gather-only divergence views. The output holds numpy arrays and is
array-equal to the JAX packer's; ``GraphBatch.to(device)`` moves it to torch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from p_div_gnn_tpu_torch.graphs.build import MeshGraph
from p_div_gnn_tpu_torch.graphs.container import (
    EDGE_BLOCK,
    NODE_FIELDS,
    NODE_TILE,
    SND_BLOCK,
    GraphBatch,
)


@dataclasses.dataclass
class GraphSample:
    """One mesh sample on the host (reference dataset row, C6)."""

    graph: MeshGraph
    mean_stress: np.ndarray  # (3,)
    local_stress: np.ndarray  # (N, 3)
    node_labels: np.ndarray  # (N,) int in {-1, 0, 1}
    div_data: np.ndarray  # (nnz,) f32
    div_row: np.ndarray  # (nnz,) int
    div_col: np.ndarray  # (nnz,) int, in [0, 2N) component-major
    von_mises: float = 0.0
    mesh_id: int = -1

    @property
    def num_nodes(self) -> int:
        return self.graph.num_nodes

    @property
    def num_edges(self) -> int:
        return self.graph.num_edges

    @property
    def num_div_entries(self) -> int:
        return int(self.div_data.shape[0])


@dataclasses.dataclass
class NodeFieldSample(GraphSample):
    """A sample with the per-node inputs and targets of another model than
    P-DivGNN (MeshGraphNets), which ``pack_batch`` packs into the batch's
    ``node_inputs`` / ``node_targets``. A subclass, so that GraphSample's
    fields stay the JAX package's sample's."""

    node_inputs: np.ndarray | None = None  # (N, F)
    node_targets: np.ndarray | None = None  # (N, T)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# Sender-view padding: snd_perm padding slots point at edge slot 0 (a valid
# index) and snd_sorted padding slots carry -1, so a block-CSR scatter over
# the view adds nothing for them.
PAD_SLOT = np.int32(0)
PAD_NODE = np.int32(-1)


def blockify_edges(
    senders: np.ndarray,
    receivers: np.ndarray,
    edge_weight: np.ndarray,
    edge_gid: np.ndarray,
    num_nodes: int,
    n_graphs: int,
    tile: int = NODE_TILE,
    edge_block: int = EDGE_BLOCK,
    min_capacity: int = 0,
) -> tuple[np.ndarray, ...]:
    """Re-lay receiver-sorted edges into a block-aligned CSR layout.

    Every ``tile``-node range's edge run is padded to a multiple of
    ``edge_block`` (at least one block per tile), and a per-block tile index
    is emitted. Dummy edges receive at their tile's last node (keeping the
    global receiver array sorted) and carry ``edge_gid == n_graphs``.

    Returns (senders, receivers, edge_weight, edge_gid, tile_ptr,
    edge_block_tile).
    """
    if num_nodes % tile:
        raise ValueError(f"num_nodes {num_nodes} is not a multiple of tile {tile}")
    n_tiles = num_nodes // tile
    counts = np.bincount(
        np.minimum(receivers // tile, n_tiles - 1), minlength=n_tiles
    )
    cap = np.maximum(((counts + edge_block - 1) // edge_block), 1) * edge_block
    total = int(cap.sum())
    if min_capacity and total < min_capacity:
        if (min_capacity - total) % edge_block:
            raise ValueError(
                f"min_capacity {min_capacity} not edge_block({edge_block})-"
                f"aligned with layout total {total}"
            )
        cap[-1] += min_capacity - total  # whole extra blocks on the last tile
        total = min_capacity
    starts = np.concatenate([[0], np.cumsum(cap)])[:-1]

    o_snd = np.full(total, num_nodes - 1, senders.dtype)
    o_rcv = np.empty(total, receivers.dtype)
    o_ew = np.zeros((total,) + edge_weight.shape[1:], edge_weight.dtype)
    o_eg = np.full(total, n_graphs, edge_gid.dtype)
    for t in range(n_tiles):
        o_rcv[starts[t] : starts[t] + cap[t]] = t * tile + (tile - 1)
    # real edges go to their tile's block start (they are contiguous in the
    # receiver-sorted input)
    in_starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    for t in range(n_tiles):
        c = counts[t]
        if c:
            s_in, s_out = in_starts[t], starts[t]
            o_snd[s_out : s_out + c] = senders[s_in : s_in + c]
            o_rcv[s_out : s_out + c] = receivers[s_in : s_in + c]
            o_ew[s_out : s_out + c] = edge_weight[s_in : s_in + c]
            o_eg[s_out : s_out + c] = edge_gid[s_in : s_in + c]
    tile_ptr = np.concatenate([starts, [total]]).astype(np.int32)
    edge_block_tile = np.repeat(
        np.arange(n_tiles, dtype=np.int32), cap // edge_block
    )
    return o_snd, o_rcv, o_ew, o_eg, tile_ptr, edge_block_tile


def blockify_edges_pair(
    senders: np.ndarray,
    receivers: np.ndarray,
    edge_weight: np.ndarray,
    edge_gid: np.ndarray,
    num_nodes: int,
    n_graphs: int,
    tile: int = NODE_TILE,
    edge_block: int = EDGE_BLOCK,
    min_capacity: int = 0,
) -> tuple[np.ndarray, ...]:
    """Pair-blocked layout of the ``fused2`` edge step: edges grouped by
    (receiver tile, sender tile), each group padded to a whole number of
    ``edge_block`` slots, in receiver-tile-major order, so that both
    endpoints of every slot of a block lie in one node tile each. Every
    receiver tile gets at least one block. Receivers stay sorted within a
    group (the input is receiver-sorted) and restart at the next group.

    Padding slots point receiver and sender at the last node of their
    group's tiles and carry ``edge_gid == n_graphs``.

    Returns (senders, receivers, edge_weight, edge_gid, tile_ptr,
    edge_block_tile (receiver tile per block), edge_block_snd_tile (sender
    tile per block)).
    """
    if num_nodes % tile:
        raise ValueError(f"num_nodes {num_nodes} is not a multiple of tile {tile}")
    n_tiles = num_nodes // tile
    rt = np.minimum(receivers // tile, n_tiles - 1).astype(np.int64)
    st = np.minimum(senders // tile, n_tiles - 1).astype(np.int64)
    key = rt * n_tiles + st
    order = np.argsort(key, kind="stable")
    pairs, counts = np.unique(key[order], return_counts=True)
    # every receiver tile needs at least one block so R covers all tiles
    missing_rt = np.setdiff1d(np.arange(n_tiles, dtype=np.int64), pairs // n_tiles)
    pairs = np.concatenate([pairs, missing_rt * n_tiles + missing_rt])
    counts = np.concatenate([counts, np.zeros(len(missing_rt), np.int64)])
    resort = np.argsort(pairs, kind="stable")
    pairs, counts = pairs[resort], counts[resort]

    cap = np.maximum((counts + edge_block - 1) // edge_block, 1) * edge_block
    total = int(cap.sum())
    if min_capacity and total < min_capacity:
        if (min_capacity - total) % edge_block:
            raise ValueError(
                f"min_capacity {min_capacity} not edge_block({edge_block})-"
                f"aligned with pair layout total {total}"
            )
        cap[-1] += min_capacity - total
        total = min_capacity
    starts = np.concatenate([[0], np.cumsum(cap)])[:-1]

    p_rt = (pairs // n_tiles).astype(np.int32)
    p_st = (pairs % n_tiles).astype(np.int32)
    o_snd = np.empty(total, senders.dtype)
    o_rcv = np.empty(total, receivers.dtype)
    o_ew = np.zeros((total,) + edge_weight.shape[1:], edge_weight.dtype)
    o_eg = np.full(total, n_graphs, edge_gid.dtype)
    for g in range(len(pairs)):
        o_rcv[starts[g] : starts[g] + cap[g]] = p_rt[g] * tile + (tile - 1)
        o_snd[starts[g] : starts[g] + cap[g]] = p_st[g] * tile + (tile - 1)
    in_starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    for g in range(len(pairs)):
        c = counts[g]
        if c:
            src = order[in_starts[g] : in_starts[g] + c]
            o_snd[starts[g] : starts[g] + c] = senders[src]
            o_rcv[starts[g] : starts[g] + c] = receivers[src]
            o_ew[starts[g] : starts[g] + c] = edge_weight[src]
            o_eg[starts[g] : starts[g] + c] = edge_gid[src]
    edge_block_tile = np.repeat(p_rt, cap // edge_block)
    edge_block_snd_tile = np.repeat(p_st, cap // edge_block)
    # per-receiver-tile CSR offsets (the blocks of one receiver tile are
    # contiguous)
    tile_tot = np.zeros(n_tiles, np.int64)
    np.add.at(tile_tot, p_rt, cap)
    tile_ptr = np.concatenate([[0], np.cumsum(tile_tot)]).astype(np.int32)
    return (
        o_snd, o_rcv, o_ew, o_eg, tile_ptr,
        edge_block_tile.astype(np.int32),
        edge_block_snd_tile.astype(np.int32),
    )


def build_sender_view(
    senders: np.ndarray,
    num_nodes: int,
    tile: int = NODE_TILE,
    edge_block: int = SND_BLOCK,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sender-major blockified view of an edge layout: edge slots re-sorted
    by sender tile, per-tile runs padded to ``edge_block``. It feeds the
    block-CSR scatter of the sender gather's backward.

    Returns (snd_perm (Ep2,) i32 — source edge slot or PAD_SLOT,
             snd_sorted (Ep2,) i32 — sender node id per slot,
             snd_block_tile (Ep2/edge_block,) i32 — sender tile per block).
    """
    if num_nodes % tile:
        raise ValueError(f"num_nodes {num_nodes} is not a multiple of tile {tile}")
    n_tiles = num_nodes // tile
    s_tile = np.minimum(senders // tile, n_tiles - 1)
    counts = np.bincount(s_tile, minlength=n_tiles)
    cap = np.maximum((counts + edge_block - 1) // edge_block, 1) * edge_block
    total = int(cap.sum())
    starts = np.concatenate([[0], np.cumsum(cap)])[:-1]

    order = np.argsort(s_tile, kind="stable")
    snd_perm = np.full(total, PAD_SLOT, np.int32)
    snd_sorted = np.full(total, PAD_NODE, np.int32)
    in_starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    for t in range(n_tiles):
        c = counts[t]
        if c:
            src = order[in_starts[t] : in_starts[t] + c]
            snd_perm[starts[t] : starts[t] + c] = src
            snd_sorted[starts[t] : starts[t] + c] = senders[src]
    snd_block_tile = np.repeat(
        np.arange(n_tiles, dtype=np.int32), cap // edge_block
    )
    return snd_perm, snd_sorted, snd_block_tile


def pad_sender_view(
    snd_perm: np.ndarray,
    snd_sorted: np.ndarray,
    snd_block_tile: np.ndarray,
    target_capacity: int,
    num_nodes: int,
    tile: int = NODE_TILE,
    edge_block: int = SND_BLOCK,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Grow a sender view to a common capacity (whole padding blocks on the
    last tile, which add nothing) so that views stack across shards."""
    cur = len(snd_perm)
    if target_capacity % edge_block or target_capacity < cur:
        raise ValueError(f"target capacity {target_capacity} is below {cur} or not a "
                         f"multiple of {edge_block}")
    if cur == target_capacity:
        return snd_perm, snd_sorted, snd_block_tile
    extra = target_capacity - cur
    last_tile = num_nodes // tile - 1
    return (
        np.concatenate([snd_perm, np.full(extra, PAD_SLOT, np.int32)]),
        np.concatenate([snd_sorted, np.full(extra, PAD_NODE, np.int32)]),
        np.concatenate([snd_block_tile, np.full(extra // edge_block, last_tile, np.int32)]),
    )


def _ell_from_coo(
    key: np.ndarray,
    payloads: tuple[np.ndarray, ...],
    num_rows: int,
    pads: tuple,
    w_bucket: int = 4,
) -> tuple[np.ndarray, ...]:
    """Pack COO entries into a padded ELL table: row r's entries occupy
    ``out[r, :counts[r]]``; W = max fan-in rounded up to ``w_bucket``."""
    K = len(key)
    order = np.argsort(key, kind="stable")
    k_sorted = key[order].astype(np.int64)
    counts = np.bincount(k_sorted, minlength=num_rows)
    W = _round_up(int(max(counts.max() if K else 0, 1)), w_bucket)
    starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    flat = k_sorted * W + (np.arange(K, dtype=np.int64) - starts[k_sorted])
    outs = []
    for payload, pad in zip(payloads, pads):
        o = np.full(num_rows * W, pad, dtype=payload.dtype)
        o[flat] = payload[order]
        outs.append(o.reshape(num_rows, W))
    return tuple(outs)


def build_div_ell(
    div_data: np.ndarray,
    div_row: np.ndarray,
    div_col_node: np.ndarray,
    div_col_is_y: np.ndarray,
    num_nodes: int,
) -> dict[str, np.ndarray]:
    """Gather-only (ELL) views of the divergence operator: the row view
    (forward, per padded node r: W slots of (source node, value, is_y)) and
    the transpose view (backward, per source node: Wt slots of (row node,
    value, is_y)). Padding slots point at node num_nodes−1 with value 0."""
    pads = (np.int32(num_nodes - 1), np.float32(0), np.int8(0))
    src, val, isy = _ell_from_coo(
        div_row.astype(np.int64),
        (div_col_node.astype(np.int32), div_data.astype(np.float32),
         div_col_is_y.astype(np.int8)),
        num_nodes,
        pads=pads,
    )
    trow, tval, tisy = _ell_from_coo(
        div_col_node.astype(np.int64),
        (div_row.astype(np.int32), div_data.astype(np.float32),
         div_col_is_y.astype(np.int8)),
        num_nodes,
        pads=pads,
    )
    return {
        "div_src": src, "div_val": val, "div_isy": isy,
        "divT_row": trow, "divT_val": tval, "divT_isy": tisy,
    }


def rcm_order(edge_index: np.ndarray, num_nodes: int) -> np.ndarray:
    """Reverse Cuthill-McKee node ordering of one graph: ``perm[i]`` is the
    original index of the node placed at position ``i``. It puts both
    endpoints of almost every edge in the same or a neighbouring node tile;
    the model is permutation-equivariant, so only float reduction order
    changes."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    adj = coo_matrix(
        (
            np.ones(edge_index.shape[1], np.int8),
            (edge_index[0], edge_index[1]),
        ),
        shape=(num_nodes, num_nodes),
    ).tocsr()
    return np.asarray(
        reverse_cuthill_mckee(adj, symmetric_mode=True), dtype=np.int64
    )


def _reorder_sample(s: GraphSample) -> tuple[GraphSample, np.ndarray]:
    """RCM-permuted copy of a sample (host-side numpy; O(N + E))."""
    n = s.num_nodes
    perm = rcm_order(np.asarray(s.graph.edge_index), n)
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    g = s.graph
    graph = dataclasses.replace(
        g,
        pos=np.asarray(g.pos)[perm],
        edge_index=inv[np.asarray(g.edge_index)],
        faces=(inv[np.asarray(g.faces)] if g.faces is not None else None),
    )
    per_node = {name: np.asarray(getattr(s, name))[perm] for name in NODE_FIELDS
                if getattr(s, name, None) is not None}
    cols = np.asarray(s.div_col, np.int64)
    comp, node = cols // n, cols % n
    # entries with col >= 2n (virtual strain dofs) are dropped by pack_batch;
    # map only the in-range ones and keep the drop marker intact
    new_cols = np.where(comp < 2, comp * n + inv[np.clip(node, 0, n - 1)], cols)
    return (
        dataclasses.replace(
            s,
            graph=graph,
            local_stress=np.asarray(s.local_stress)[perm],
            node_labels=np.asarray(s.node_labels)[perm],
            **per_node,
            div_row=inv[np.asarray(s.div_row, np.int64)],
            div_col=new_cols,
        ),
        perm,
    )


def _bucket(x: int, m: int, buckets: tuple[int, ...] | None) -> int:
    """``x`` rounded up to a multiple of ``m``, then up to the first bucket
    that holds it (itself when none does)."""
    x = _round_up(x, m)
    for b in buckets or ():
        if x <= b:
            return b
    return x


def default_node_buckets(max_nodes: int = 1 << 17) -> tuple[int, ...]:
    """The loader's node-capacity ladder: 1024, 1536, 2048, 3072, ... up to
    ``max_nodes``, two rungs per octave (at most ~1/3 padding)."""
    buckets = []
    b = 1024
    while b <= max_nodes:
        buckets += [b, b + b // 2]
        b *= 2
    return tuple(buckets)


def pack_batch(
    samples: list[GraphSample],
    n_graphs: int | None = None,
    pad_nodes: int | None = None,
    pad_edges: int | None = None,
    pad_div: int | None = None,
    tile: int = NODE_TILE,
    node_buckets: tuple[int, ...] | None = None,
    edge_buckets: tuple[int, ...] | None = None,
    pair_blocks: bool = False,
    sender_view: bool = True,
    div_ell: bool = True,
    reorder: str | None = None,
) -> GraphBatch:
    """Concatenate samples into one padded batch (host-side, numpy).

    Node layout: graphs contiguous in input order, then padding (at least
    one padding node). Edges are sorted by receiver and re-laid into the
    block-aligned CSR layout, or with ``pair_blocks`` into the pair-blocked
    layout of the ``fused2`` path (``blockify_edges_pair``, which sets
    ``edge_block_snd_tile``); padding edges are masked by
    ``edge_gid == n_graphs``. ``sender_view`` (built over the layout's
    senders) and ``div_ell`` build the views that only training reads.

    Capacities: ``pad_nodes`` / ``pad_edges`` / ``pad_div`` fix the node,
    edge-slot and divergence-entry counts (``GraphLoader`` sets them from
    its bucket ladder); unset, they are the content rounded up (nodes + 1 to
    the tile, then the first of ``node_buckets`` that holds it; edges to 512,
    then ``edge_buckets``; entries to 512). The edge capacity is then rounded
    up to whole edge blocks.
    """
    G = n_graphs if n_graphs is not None else len(samples)
    if len(samples) > G:
        raise ValueError(f"{len(samples)} samples do not fit n_graphs={G}")
    perms = None
    if reorder is not None:
        if reorder != "rcm":
            raise ValueError(f"unknown reorder {reorder!r}")
        reordered = [_reorder_sample(s) for s in samples]
        samples = [s for s, _ in reordered]
        perms = [p for _, p in reordered]
    tot_nodes = sum(s.num_nodes for s in samples)
    tot_edges = sum(s.num_edges for s in samples)
    tot_div = sum(s.num_div_entries for s in samples)

    Np = pad_nodes if pad_nodes is not None else _bucket(tot_nodes + 1, tile, node_buckets)
    Ep = pad_edges if pad_edges is not None else _bucket(max(tot_edges, 1), 512, edge_buckets)
    Ep = _round_up(Ep, EDGE_BLOCK)
    Kp = pad_div if pad_div is not None else _round_up(max(tot_div, 1), 512)
    if Np <= tot_nodes:
        raise ValueError(f"pad_nodes {Np} leaves no padding node for {tot_nodes} nodes")
    if Ep < tot_edges or Kp < tot_div:
        raise ValueError(f"capacities Ep={Ep}, Kp={Kp} below the content's "
                         f"{tot_edges} edges, {tot_div} divergence entries")

    pos = np.zeros((Np, 2), np.float32)
    mean_stress = np.zeros((Np, 3), np.float32)
    node_type = np.zeros((Np, 1), np.float32)
    local_stress = np.zeros((Np, 3), np.float32)
    node_gid = np.full(Np, G, np.int32)

    senders = np.full(Ep, Np - 1, np.int32)
    receivers = np.full(Ep, Np - 1, np.int32)
    edge_weight = np.zeros((Ep, 1), np.float32)
    edge_gid = np.full(Ep, G, np.int32)

    div_data = np.zeros(Kp, np.float32)
    div_row = np.full(Kp, Np - 1, np.int32)
    div_col_node = np.full(Kp, Np - 1, np.int32)
    div_col_is_y = np.zeros(Kp, np.int32)

    graph_node_count = np.zeros(G, np.int32)
    graph_node_offset = np.zeros(G, np.int32)
    per_node = {name: _node_field(samples, name, Np) for name in NODE_FIELDS}

    n_off = e_off = k_off = 0
    for g, s in enumerate(samples):
        n, e = s.num_nodes, s.num_edges
        pos[n_off : n_off + n] = np.asarray(s.graph.pos[:, :2], np.float32)
        mean_stress[n_off : n_off + n] = np.asarray(s.mean_stress, np.float32)
        node_type[n_off : n_off + n, 0] = np.asarray(s.node_labels, np.float32)
        local_stress[n_off : n_off + n] = np.asarray(s.local_stress, np.float32)
        node_gid[n_off : n_off + n] = g
        for name, out in per_node.items():
            if out is not None:
                out[n_off : n_off + n] = np.asarray(getattr(s, name), np.float32)

        senders[e_off : e_off + e] = s.graph.edge_index[0] + n_off
        receivers[e_off : e_off + e] = s.graph.edge_index[1] + n_off
        edge_weight[e_off : e_off + e, 0] = s.graph.edge_weight
        edge_gid[e_off : e_off + e] = g

        # Divergence COO: column c in [0, 2N) → (node c % N, component
        # c // N) — component-major dofs (`gnn_train.py:68-70`). Entries with
        # col >= 2N (virtual strain nodes) are dropped.
        cols = np.asarray(s.div_col, np.int64)
        keep = cols < 2 * n
        k = int(keep.sum())
        div_data[k_off : k_off + k] = np.asarray(s.div_data, np.float32)[keep]
        div_row[k_off : k_off + k] = np.asarray(s.div_row, np.int64)[keep] + n_off
        div_col_node[k_off : k_off + k] = (cols[keep] % n) + n_off
        div_col_is_y[k_off : k_off + k] = (cols[keep] // n).astype(np.int32)
        graph_node_count[g] = n
        graph_node_offset[g] = n_off
        n_off += n
        e_off += e
        k_off += k

    # CSR-sort edges by receiver (stable keeps canonical (s, r) order within
    # a receiver), then re-lay into the block-aligned layout.
    order = np.argsort(receivers[:e_off], kind="stable")
    sorted_edges = (senders[:e_off][order], receivers[:e_off][order],
                    edge_weight[:e_off][order], edge_gid[:e_off][order])
    edge_block_snd_tile = None
    if pair_blocks:
        (senders, receivers, edge_weight, edge_gid, tile_ptr, edge_block_tile,
         edge_block_snd_tile) = blockify_edges_pair(
            *sorted_edges, num_nodes=Np, n_graphs=G, tile=tile, min_capacity=Ep)
    else:
        senders, receivers, edge_weight, edge_gid, tile_ptr, edge_block_tile = (
            blockify_edges(*sorted_edges, num_nodes=Np, n_graphs=G, tile=tile,
                           min_capacity=Ep)
        )

    snd_perm = snd_sorted = snd_block_tile = None
    if sender_view:
        snd_perm, snd_sorted, snd_block_tile = build_sender_view(
            senders, num_nodes=Np, tile=tile
        )
    # gather-only divergence views, built from the real entries only
    ell = {}
    if div_ell:
        ell = build_div_ell(
            div_data[:k_off], div_row[:k_off], div_col_node[:k_off],
            div_col_is_y[:k_off], num_nodes=Np,
        )
    node_order = None
    if perms is not None:
        node_order = np.zeros(Np, np.int32)
        for g, s in enumerate(samples):
            off = int(graph_node_offset[g])
            node_order[off : off + s.num_nodes] = perms[g].astype(np.int32)
    return GraphBatch(
        node_order=node_order,
        **ell,
        **per_node,
        pos=pos,
        mean_stress=mean_stress,
        node_type=node_type,
        local_stress=local_stress,
        node_gid=node_gid,
        senders=senders,
        receivers=receivers,
        edge_weight=edge_weight,
        edge_gid=edge_gid,
        tile_ptr=tile_ptr,
        edge_block_tile=edge_block_tile,
        edge_block_snd_tile=edge_block_snd_tile,
        snd_perm=snd_perm,
        snd_sorted=snd_sorted,
        snd_block_tile=snd_block_tile,
        div_data=div_data,
        div_row=div_row,
        div_col_node=div_col_node,
        div_col_is_y=div_col_is_y,
        graph_node_count=graph_node_count,
        graph_node_offset=graph_node_offset,
        n_graphs=G,
        tile=tile,
    )


def _node_field(samples: list[GraphSample], name: str, Np: int) -> np.ndarray | None:
    """The (Np, C) zeros that the samples' per-node field ``name`` fills, or
    None where no sample has it; a batch takes it from every sample or
    from none."""
    given = [getattr(s, name, None) is not None for s in samples]
    if not any(given):
        return None
    if not all(given):
        raise ValueError(f"pack_batch: {name} is given for some samples and not others")
    widths = {np.asarray(getattr(s, name)).shape[1] for s in samples}
    if len(widths) != 1:
        raise ValueError(f"pack_batch: the samples' {name} differ in width: {sorted(widths)}")
    return np.zeros((Np, widths.pop()), np.float32)


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def unpack_predictions(batch: GraphBatch, prediction: np.ndarray) -> list[np.ndarray]:
    """Slice a (Np, C) node prediction (or per-node field, such as the
    batch's ``node_targets``) back into per-graph arrays in each mesh's
    original node order (`data_utils.py:36-43`). The batch may be on the
    host or on a device."""
    out = []
    counts = _host(batch.graph_node_count)
    offsets = _host(batch.graph_node_offset)
    order = None if batch.node_order is None else _host(batch.node_order)
    for g in range(batch.n_graphs):
        n = int(counts[g])
        if n == 0:
            continue
        off = int(offsets[g])
        pred = np.asarray(prediction[off : off + n])
        if order is not None:
            # packed row i holds the node whose original index is order[off+i]
            orig = np.empty_like(pred)
            orig[order[off : off + n]] = pred
            pred = orig
        out.append(pred)
    return out
