"""A typed graph: several node sets and several edge sets between them, each
edge set laid out for the port's block-CSR kernels. It has no counterpart
in the JAX package, whose ``GraphBatch`` (``graphs/container.py``) holds one
node set and one edge set within it.

- A node set (``NodeSet``) holds its real nodes' latitude and longitude,
  its structural features, and capacity for padding: ``n_padded`` is a
  whole number of node tiles (``NODE_TILE``) with at least one padding
  node, whose features are zero.
- An edge set (``EdgeSet``) sends from one node set to another (or the
  same). Its slots are laid out receiver-major in block-CSR over the
  receiver set (``batching.blockify_edges``: every receiver tile's run
  padded to whole edge blocks, each receiver's slots consecutive), with its
  sender view over the sender set (``batching.build_sender_view``), so #3
  sums into either set and the sender gather's backward runs over either.
  A padding slot receives at its tile's last node, sends from the sender
  set's last (padding) node, has zero features and is masked (``mask``).
- ``TypedGraph.to(device)`` moves every array once and derives each sender
  view's run order there (``container.sender_run_order``); a graph already
  on the device is returned as it is, so the run checks cached on its
  tensors run once.
- ``TypedSample`` is one sample of node states over a fixed graph: inputs
  and targets of one node set's rows, zero on its padding rows.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from p_div_gnn_tpu_torch.graphs.batching import _round_up, blockify_edges, build_sender_view
from p_div_gnn_tpu_torch.graphs.container import NODE_TILE, sender_run_order

Array = Any  # np.ndarray on the host, torch.Tensor on the device


def padded_size(n: int, tile: int = NODE_TILE) -> int:
    """Whole node tiles holding ``n`` nodes and at least one padding node."""
    return _round_up(n + 1, tile)


def _tensor(v: Array, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(v).to(device)


@dataclasses.dataclass
class NodeSet:
    n: int  # real nodes, rows 0 .. n - 1
    n_padded: int
    lat: np.ndarray  # (n,) f64 degrees
    lon: np.ndarray  # (n,) f64 degrees in [0, 360)
    features: Array  # (n_padded, F) f32 structural features, zero on padding

    def to(self, device: torch.device) -> "NodeSet":
        return dataclasses.replace(self, features=_tensor(self.features, device))


@dataclasses.dataclass
class EdgeSet:
    sender_set: str
    receiver_set: str
    n: int  # real edges
    senders: Array  # (Ep,) i32 into the sender set
    receivers: Array  # (Ep,) i32 into the receiver set, block-CSR
    real: Array  # (Ep,) bool
    features: Array  # (Ep, F) f32, zero on padding slots
    tile_ptr: Array  # (n_receiver_tiles + 1,) i32
    block_tile: Array  # (Ep / block,) i32 receiver tile of each edge block
    snd_perm: Array  # (Ep2,) i32 the sender view's source slots
    snd_sorted: Array  # (Ep2,) i32 its senders, -1 on padding
    snd_block_tile: Array  # (Ep2 / block,) i32 its sender tile of each block
    snd_run_perm: Array | None = None  # the view in run order, made by .to()
    snd_run_sorted: Array | None = None
    mask: Array | None = None  # (Ep, 1) f32 of ``real``, made by .to()
    tile: int = NODE_TILE

    @property
    def slots(self) -> int:
        return int(self.senders.shape[0])

    @property
    def view(self) -> tuple:
        """(snd_run_perm, snd_run_sorted, snd_block_tile), as the sender
        gathers take the view."""
        return (self.snd_run_perm, self.snd_run_sorted, self.snd_block_tile)

    def to(self, device: torch.device) -> "EdgeSet":
        names = ("senders", "receivers", "real", "features", "tile_ptr", "block_tile",
                 "snd_perm", "snd_sorted", "snd_block_tile")
        moved = {k: _tensor(getattr(self, k), device) for k in names}
        moved["snd_run_perm"], moved["snd_run_sorted"] = sender_run_order(
            moved["snd_perm"], moved["snd_sorted"], moved["snd_block_tile"])
        moved["mask"] = moved["real"].to(torch.float32)[:, None]
        return dataclasses.replace(self, **moved)


def layout_edges(senders: np.ndarray, receivers: np.ndarray, features: np.ndarray,
                 nodes: dict[str, NodeSet], sender_set: str, receiver_set: str,
                 tile: int = NODE_TILE) -> EdgeSet:
    """An edge set of real edges ``senders[i] → receivers[i]`` with their
    ``features`` (E, F), laid out receiver-major in block-CSR over the
    receiver set (receivers sorted, then senders) with its sender view."""
    order = np.lexsort((senders, receivers))
    n_s, n_r = nodes[sender_set].n_padded, nodes[receiver_set].n_padded
    snd, rcv, feat, gid, tile_ptr, block_tile = blockify_edges(
        senders[order].astype(np.int32), receivers[order].astype(np.int32),
        features[order].astype(np.float32), np.zeros(len(order), np.int32), n_r, 1, tile)
    real = gid < 1
    snd[~real] = n_s - 1
    snd_perm, snd_sorted, snd_block_tile = build_sender_view(snd, n_s, tile)
    return EdgeSet(sender_set, receiver_set, len(order), snd, rcv, real, feat, tile_ptr,
                   block_tile, snd_perm, snd_sorted, snd_block_tile, tile=tile)


@dataclasses.dataclass
class TypedGraph:
    nodes: dict[str, NodeSet]
    edges: dict[str, EdgeSet]

    def is_on(self, device: str | torch.device) -> bool:
        device = torch.device(device)
        return all(isinstance(e.senders, torch.Tensor) and e.senders.device.type == device.type
                   and (device.index is None or e.senders.device.index == device.index)
                   for e in self.edges.values())

    def to(self, device: str | torch.device) -> "TypedGraph":
        """A copy with every array a tensor on ``device`` (each sender view's
        run order derived there), or the graph itself if it is there."""
        if self.is_on(device):
            return self
        device = torch.device(device)
        return TypedGraph({k: v.to(device) for k, v in self.nodes.items()},
                          {k: v.to(device) for k, v in self.edges.items()})

    def counts(self) -> dict[str, int]:
        """The real nodes of each node set and real edges of each edge set."""
        return {**{f"{k}_nodes": v.n for k, v in self.nodes.items()},
                **{f"{k}_edges": v.n for k, v in self.edges.items()}}


@dataclasses.dataclass
class TypedSample:
    """One sample of node states over a fixed ``graph``: ``inputs`` and
    ``targets`` of the rows of its node set ``node_set``, zero on padding
    rows. A sample is a batch of one graph (``n_graphs``) whose real nodes
    ``graph_node_count`` gives, as ``GraphBatch`` counts them."""

    graph: TypedGraph
    inputs: Array  # (n_padded, F) f32
    targets: Array  # (n_padded, T) f32
    graph_node_count: Array  # (1,) i32
    node_set: str = "grid"
    n_graphs: int = 1

    def to(self, device: str | torch.device, non_blocking: bool = False) -> "TypedSample":
        """A copy on ``device`` (the graph moved once, see ``TypedGraph.to``),
        or the sample itself if it is there."""
        arrays = (self.inputs, self.targets, self.graph_node_count)
        device = torch.device(device)
        if self.graph.is_on(device) and all(
                isinstance(a, torch.Tensor) and a.device.type == device.type for a in arrays):
            return self
        inputs, targets, count = (torch.as_tensor(a).to(device, non_blocking=non_blocking)
                                  for a in arrays)
        return dataclasses.replace(self, graph=self.graph.to(device), inputs=inputs,
                                   targets=targets, graph_node_count=count)
