"""Static-shape padded graph batch — the device-facing data structure.

The jax-free counterpart of ``p_div_gnn_tpu/graphs/container.py``: the same
fields with the same layout contract, held as numpy arrays on the host
(``pack_batch``'s output) and as torch tensors after ``.to(device)``.

- nodes of graph g occupy a contiguous range; padding nodes carry
  ``node_gid == n_graphs``;
- edges are sorted by receiver in a block-aligned CSR layout: every
  ``tile``-node range's edge run is padded to a whole number of edge blocks,
  and ``edge_block_tile`` names the node tile of each block (the fused
  edge-step kernel reads both sizes from the batch); a pair-blocked batch
  (``pack_batch(pair_blocks=True)``, the ``fused2`` path) groups them by
  (receiver tile, sender tile) instead and names each block's sender tile
  in ``edge_block_snd_tile``: its receivers are not globally sorted;
- padding edges carry ``edge_gid == n_graphs`` and contribute nothing.

Beyond the JAX package's fields, ``.to(device)`` derives from the sender
view, on the device, the order in which the port's block-CSR segment sum
reads it (``snd_run_perm``, ``snd_run_sorted``; see ``sender_run_order``),
and a batch may carry per-node inputs and targets of another model than
P-DivGNN (``node_inputs``, ``node_targets``: MeshGraphNets' velocity and
node type, and its velocity change), zero on padding nodes and ``None``
in a P-DivGNN batch.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

Array = Any  # np.ndarray on the host, torch.Tensor on the device

# Layout constants of the JAX package's defaults (graphs/container.py:43,
# 49, 58): edge-stream block, node tile of the block-aligned CSR layout,
# sender-view block.
EDGE_BLOCK = 768
NODE_TILE = 256
SND_BLOCK = EDGE_BLOCK
# the port's own optional per-node fields, which the JAX package's batch lacks
NODE_FIELDS = ("node_inputs", "node_targets")


@dataclasses.dataclass
class GraphBatch:
    # --- nodes (capacity Np; graphs contiguous; >=1 trailing padding node)
    pos: Array  # (Np, 2) f32
    mean_stress: Array  # (Np, 3) f32 (macroscopic stress broadcast per node)
    node_type: Array  # (Np, 1) f32 in {-1, 0, 1}
    local_stress: Array  # (Np, 3) f32 (target field; zeros at inference)
    node_gid: Array  # (Np,) i32 graph id; == n_graphs for padding

    # --- edges (capacity Ep; block-aligned CSR by receiver)
    senders: Array  # (Ep,) i32
    receivers: Array  # (Ep,) i32
    edge_weight: Array  # (Ep, 1) f32 (0 on periodic + padding edges)
    edge_gid: Array  # (Ep,) i32 == n_graphs for padding
    tile_ptr: Array  # (Np // tile + 1,) i32 CSR offsets per node tile
    edge_block_tile: Array  # (Ep // block,) i32 node tile per edge block

    # --- divergence operator, padded COO (capacity Kp)
    div_data: Array  # (Kp,) f32
    div_row: Array  # (Kp,) i32
    div_col_node: Array  # (Kp,) i32
    div_col_is_y: Array  # (Kp,) i32

    # --- per-graph metadata (capacity G = n_graphs)
    graph_node_count: Array  # (G,) i32 (0 for padding graphs)
    graph_node_offset: Array  # (G,) i32

    # --- optional sender-major edge view (batching.build_sender_view)
    snd_perm: Array | None = None  # (Ep2,) i32
    snd_sorted: Array | None = None  # (Ep2,) i32
    snd_block_tile: Array | None = None  # (Ep2 / block,) i32

    # --- optional gather-only (ELL) divergence views (batching.build_div_ell)
    div_src: Array | None = None  # (Np, W) i32
    div_val: Array | None = None  # (Np, W) f32
    div_isy: Array | None = None  # (Np, W) i8
    divT_row: Array | None = None  # (Np, Wt) i32
    divT_val: Array | None = None  # (Np, Wt) f32
    divT_isy: Array | None = None  # (Np, Wt) i8

    # --- optional node-reordering record (pack_batch(reorder="rcm")):
    # node_order[off+i] = original local index of the node at packed row
    # off+i; unpack_predictions inverts it.
    node_order: Array | None = None  # (Np,) i32

    # --- optional pair-blocked layout marker (batching.blockify_edges_pair,
    # scatter_impl="fused2"): sender tile per edge block
    edge_block_snd_tile: Array | None = None  # (Ep // block,) i32

    # --- the sender view in run order (sender_run_order), made by .to():
    # each tile's slots stably sorted by sender, padding last
    snd_run_perm: Array | None = None  # (Ep2,) i32
    snd_run_sorted: Array | None = None  # (Ep2,) i32

    # --- optional per-node inputs and targets of another model than
    # P-DivGNN (pack_batch from NodeFieldSample.node_inputs /
    # node_targets), in the packed node order, zero on padding nodes
    node_inputs: Array | None = None  # (Np, F) f32
    node_targets: Array | None = None  # (Np, T) f32

    # --- static
    n_graphs: int = 1
    tile: int = NODE_TILE

    def array_fields(self) -> list[str]:
        """The fields of the JAX package's batch (the derived run order, the
        port's own per-node fields and the static sizes left out)."""
        return [
            f.name for f in dataclasses.fields(self)
            if f.name not in ("n_graphs", "tile", "snd_run_perm", "snd_run_sorted")
            + NODE_FIELDS
        ]

    def tensor_fields(self) -> list[str]:
        """Every array a device copy holds but the derived run order: the
        JAX package's fields and the port's own per-node fields."""
        return self.array_fields() + list(NODE_FIELDS)

    def is_on(self, device: str | torch.device) -> bool:
        """Whether every array is already a tensor on ``device`` (with the
        sender view's run order derived)."""
        device = torch.device(device)
        arrays = [v for name in self.tensor_fields() if (v := getattr(self, name)) is not None]
        return (self.snd_perm is None or self.snd_run_perm is not None) and all(
            isinstance(v, torch.Tensor) and v.device.type == device.type
            and (device.index is None or v.device.index == device.index)
            for v in arrays)

    def to(self, device: str | torch.device, non_blocking: bool = False) -> "GraphBatch":
        """A copy with every array as a torch tensor on ``device``, and the
        sender view's run order derived there; the batch itself when it is
        there already, so a layout kept on the device keeps its tensors (and
        the run checks cached on them). ``non_blocking`` copies host arrays
        to a CUDA device from pinned memory without waiting."""
        if self.is_on(device):
            return self
        pin = non_blocking and torch.device(device).type == "cuda"

        def move(v: Array) -> torch.Tensor:
            t = torch.as_tensor(v)
            if pin and t.device.type == "cpu":
                t = t.pin_memory()
            return t.to(device, non_blocking=non_blocking)

        moved = {
            name: None if (v := getattr(self, name)) is None else move(v)
            for name in self.tensor_fields()
        }
        if moved["snd_perm"] is not None:
            moved["snd_run_perm"], moved["snd_run_sorted"] = sender_run_order(
                moved["snd_perm"], moved["snd_sorted"], moved["snd_block_tile"])
        return dataclasses.replace(self, **moved)

    @property
    def node_mask(self) -> Array:
        return self.node_gid < self.n_graphs

    @property
    def edge_mask(self) -> Array:
        return self.edge_gid < self.n_graphs

    @property
    def graph_mask(self) -> Array:
        """(G,) True for graphs that hold nodes (padding graphs are empty)."""
        return self.graph_node_count > 0

    @property
    def n_real_graphs(self) -> int:
        return int((self.graph_node_count > 0).sum())

    @property
    def num_nodes_padded(self) -> int:
        return int(self.pos.shape[0])

    @property
    def num_edges_padded(self) -> int:
        return int(self.senders.shape[0])


def sender_run_order(
    snd_perm: torch.Tensor,  # (Ep2,) i32 source slot of each sender-view slot
    snd_sorted: torch.Tensor,  # (Ep2,) i32 sender per slot, -1 for padding
    snd_block_tile: torch.Tensor,  # (Ep2 / block,) i32 sender tile per block
) -> tuple[torch.Tensor, torch.Tensor]:
    """The sender view with each tile's slots stably sorted by sender,
    padding (-1) last: the same (slot, sender) pairs per tile, with every
    sender's slots consecutive, as ``csr_segment_sum``'s kernel needs them.
    Returns (snd_run_perm, snd_run_sorted), int32 on the inputs' device."""
    block = snd_perm.shape[0] // snd_block_tile.shape[0]
    tile_of_slot = snd_block_tile.long().repeat_interleave(block)
    key = (tile_of_slot << 32) | (snd_sorted.long() & 0xFFFFFFFF)  # -1 → 2³² − 1
    order = torch.sort(key, stable=True).indices
    return snd_perm[order].contiguous(), snd_sorted[order].contiguous()


@dataclasses.dataclass(frozen=True)
class NormStats:
    """The 8 scalar normalization statistics the reference model carries and
    checkpoints (`models.py:98-179,44-63`)."""

    mean_pos: float
    std_pos: float
    mean_mean_stress: float
    std_mean_stress: float
    mean_local_stress: float
    std_local_stress: float
    mean_edge_weight: float
    std_edge_weight: float

    @classmethod
    def from_dict(cls, d: dict[str, float]) -> "NormStats":
        return cls(**{f.name: float(d[f.name]) for f in dataclasses.fields(cls)})

    @classmethod
    def ones(cls) -> "NormStats":
        """Identity statistics: every mean 0, every std 1."""
        return cls(0.0, 1.0, 0.0, 1.0, 0.0, 1.0, 0.0, 1.0)

    def to_dict(self) -> dict[str, float]:
        return dataclasses.asdict(self)
