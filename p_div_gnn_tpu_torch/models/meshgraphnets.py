"""MeshGraphNets in torch.nn: the ``cylinder_flow`` model of Pfaff,
Fortunato, Sanchez-Gonzalez and Battaglia, "Learning Mesh-Based Simulation
with Graph Networks" (ICLR 2021, arXiv:2010.03409), as deepmind-research
``meshgraphnets/`` writes it (``core_model.py``: ``EncodeProcessDecode``,
``GraphNetBlock``; ``cfd_model.py``: features, normalisers and loss). It
has no counterpart in the JAX package.

- Node input ``[velocity (2), one_hot(node_type, 9)]`` (the batch's
  ``node_inputs``), edge input ``[p_s − p_r (2), |p_s − p_r|]`` computed
  here from the batch's positions; both normalised by fixed per-feature
  statistics (``MGNStats``), as is the target, the velocity change (the
  batch's ``node_targets``).
- Every MLP is Sonnet's ``MLP([L] * hidden_layers + [out])``: Linear →
  ReLU → ... → Linear, followed by a per-row LayerNorm (eps 1e-5) except
  on the decoder. Init as Sonnet's: kernels truncated normal (±2 σ) with
  σ = 1/√fan_in, biases 0, LayerNorm scale 1 and offset 0.
- ``message_passing_steps`` blocks with their own weights. Block k: ``e' =
  MLP_e([x_s, x_r, e])``, one evaluation per edge that is both the message
  and the edge update; ``x' = MLP_n([x, Σ_{edges into r} e'])``; then ``x
  += x'``, ``e += e'``.
- The decoder gives 2 outputs, the normalised velocity change; the loss
  (``mgn_loss``) is the mean over the NORMAL and OUTFLOW nodes of the
  squared error summed over the two components.

The edge MLP's first layer over ``[x_s, x_r, e]`` is split per slot of its
kernel, as ``models/epd.py`` does P-DivGNN's: ``x·W_s`` and ``x·W_r`` once
per node; the rest of the edge update, the two endpoint gathers, the three
layers, the LayerNorm, the mask and the residual ``e + e'``, is
``ops/mgn_edge.py::edge_update`` (on the card one kernel, ``mgn_edge_fwd``;
its backward sums the senders' rows with #3 over the batch's sender view
and the receivers' with #3 over the receiver-major layout); ``Σ e'`` is
``scatter_add(impl="pallas")`` (#3 over that layout). A training step thus
runs #3 three times a block. ``e'`` is multiplied by the edge mask, so a
padding slot adds nothing to a sum and takes no gradient; padding nodes
are left out of the loss. The card's kernel takes the published MLP
depth, 2 hidden layers; the CPU's plain version takes any.

The edge stream holds the batch's live slots only (``live_edges``): the
slots up to its last real one, in whole edge blocks
(``ops/segment.py::live_slots``). A loader's batch gives its spare edge
capacity to its last node tile, so the slots after those are all padding
and would add nothing; every edge tensor, the encoder's on, has ``n`` rows
and #3's receiver sums run over ``n`` slots. The mask stays, for the
block-alignment padding inside the receiver runs. The layout cut to ``n``
slots is kept on the batch, so a batch reused across steps reads
``live_slots`` (a device sync) once.

The model runs on one device: edge partitioning (``halo``) raises. No
block is rematerialized, as the source trains. Spans (``utils/profiling``,
``device=True``): ``mgn.encode``, ``mgn.edge`` and ``mgn.node`` (attribute
``block``) a block, ``mgn.decode``; the counter ``mgn.edge_rows`` adds the
edge stream's rows once a block, inside ``mgn.edge``, and
``mgn.edge_fused_rows`` the same rows where the block's kernel ran.

Importing this module applies the port's matmul precision policy
(``utils/precision.py``: fp32 with TF32 off by default).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from p_div_gnn_tpu_torch.graphs.batching import NodeFieldSample
from p_div_gnn_tpu_torch.graphs.container import GraphBatch
from p_div_gnn_tpu_torch.ops import mgn_edge
from p_div_gnn_tpu_torch.ops.scatter import scatter_add
from p_div_gnn_tpu_torch.ops.segment import live_slots
from p_div_gnn_tpu_torch.utils.precision import matmul_precision
from p_div_gnn_tpu_torch.utils.profiling import count, span

matmul_precision()

# cfd_model.py: node input [velocity (2), one_hot(node_type, NodeType.SIZE)],
# edge input [relative mesh position (2), its norm], output the velocity change
VELOCITY, NODE_TYPES, EDGE_FEATURES, OUT_FEATURES = 2, 9, 3, 2
NODE_FEATURES = VELOCITY + NODE_TYPES
# common.NodeType
NORMAL, OBSTACLE, AIRFOIL, HANDLE, INFLOW, OUTFLOW, WALL_BOUNDARY = 0, 1, 2, 3, 4, 5, 6
LN_EPS = 1e-5
STD_EPS = 1e-8  # normalization.Normalizer's std_epsilon


@dataclass(frozen=True)
class MGNStats:
    """Fixed per-feature normalisers, (mean, std) each: the node inputs
    (F,), the edge features (3,) and the targets (T,)."""

    node_mean: np.ndarray
    node_std: np.ndarray
    edge_mean: np.ndarray
    edge_std: np.ndarray
    target_mean: np.ndarray
    target_std: np.ndarray

    @classmethod
    def ones(cls, node: int = NODE_FEATURES, target: int = OUT_FEATURES) -> "MGNStats":
        """Identity normalisers: every mean 0, every std 1."""
        z, o = np.zeros, np.ones
        return cls(z(node), o(node), z(EDGE_FEATURES), o(EDGE_FEATURES), z(target), o(target))


def mesh_edge_features(pos: np.ndarray, edge_index: np.ndarray) -> np.ndarray:
    """(E, 3) ``[p_s − p_r, |p_s − p_r|]`` of one mesh on the host, fp64."""
    pos = np.asarray(pos, np.float64)[:, :2]
    rel = pos[edge_index[0]] - pos[edge_index[1]]
    return np.concatenate([rel, np.linalg.norm(rel, axis=1, keepdims=True)], axis=1)


def compute_mgn_stats(samples: list[NodeFieldSample]) -> MGNStats:
    """The per-feature mean and std (biased, at least ``STD_EPS``, as the
    source's ``Normalizer``) of the samples' node inputs, edge features and
    targets, in fp64: fixed statistics in place of the source's online
    accumulation."""

    def moments(parts: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
        x = np.concatenate([np.asarray(p, np.float64) for p in parts])
        return x.mean(0), np.maximum(x.std(0), STD_EPS)

    node = moments([s.node_inputs for s in samples])
    edge = moments([mesh_edge_features(s.graph.pos, s.graph.edge_index) for s in samples])
    target = moments([s.node_targets for s in samples])
    return MGNStats(*node, *edge, *target)


@dataclass(frozen=True)
class LiveEdges:
    """A batch's edge stream up to its last real slot: the first ``n``
    slots of its receiver-major layout (``live_slots``, whole edge blocks),
    and the sender view in run order with the slots at or after ``n``
    turned into its padding (source slot 0, sender -1), so the sender
    gather's backward reads an ``n``-row cotangent."""

    n: int
    senders: torch.Tensor  # (n,) i32
    receivers: torch.Tensor  # (n,) i32
    block_tile: torch.Tensor  # (n / block,) i32
    mask: torch.Tensor  # (n,) bool, the real edges
    view: tuple | None  # (snd_run_perm, snd_run_sorted, snd_block_tile), or None
    tile: int  # node tile of the layout


def live_edges(batch: GraphBatch) -> LiveEdges:
    """The batch's ``LiveEdges``, kept on the batch with ``edge_gid``'s
    version counter, as ``live_slots`` keeps its answer: a batch reused
    across steps gives the same tensors, on which #3's run check is cached
    too. A batch with no spare edge capacity keeps its sender view as it
    is, and so runs as it would over every slot."""
    key = (batch.edge_gid, batch.edge_gid._version)
    cached = getattr(batch, "_mgn_live_edges", None)
    if cached is not None and cached[0][0] is key[0] and cached[0][1] == key[1]:
        return cached[1]
    view = None
    if batch.snd_perm is not None:
        if batch.snd_run_perm is None:
            raise ValueError("the batch's sender view has no run order: move the batch "
                             "to its device with GraphBatch.to")
        view = (batch.snd_run_perm, batch.snd_run_sorted, batch.snd_block_tile)
    Ep = batch.num_edges_padded
    block = Ep // batch.edge_block_tile.shape[0]
    n = live_slots(batch.edge_gid, batch.n_graphs, block)
    if n < Ep and view is not None:
        past = view[0] >= n
        view = (view[0].masked_fill(past, 0), view[1].masked_fill(past, -1), view[2])
    live = LiveEdges(n=n, senders=batch.senders[:n], receivers=batch.receivers[:n],
                     block_tile=batch.edge_block_tile[:n // block],
                     mask=batch.edge_gid[:n] < batch.n_graphs, view=view, tile=batch.tile)
    batch._mgn_live_edges = (key, live)
    return live


def edge_features(pos: torch.Tensor, senders: torch.Tensor,
                  receivers: torch.Tensor) -> torch.Tensor:
    """(E, 3) ``[p_s − p_r, |p_s − p_r|]`` of every slot, on the device;
    a padding slot's features are masked out with its update."""
    rel = pos.index_select(0, senders) - pos.index_select(0, receivers)
    return torch.cat([rel, torch.linalg.vector_norm(rel, dim=-1, keepdim=True)], dim=-1)


def truncated_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """Sonnet's default kernel init in place: truncated normal (±2 σ) with
    σ = 1/√fan_in."""
    std = 1.0 / math.sqrt(fan_in)
    return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)


class Dense(nn.Module):
    """``x @ kernel + bias``, kernel (in, out), Sonnet's init."""

    def __init__(self, in_features: int, features: int, generator: torch.Generator):
        super().__init__()
        self.kernel = nn.Parameter(truncated_normal_(torch.empty(in_features, features),
                                                     in_features, generator))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel + self.bias


class MLP(nn.Module):
    """Sonnet's ``MLP([latent] * hidden_layers + [out])`` (``lin0``, ``lin1``,
    ...), with a per-row LayerNorm (``ln``) after it unless ``layer_norm``
    is False; ``activation`` names the function between the layers
    (``mgn_edge.ACTIVATIONS``: ReLU, as MeshGraphNets, or SiLU)."""

    def __init__(self, in_features: int, latent: int, out: int, hidden_layers: int,
                 generator: torch.Generator, layer_norm: bool = True, activation: str = "relu"):
        super().__init__()
        widths = [latent] * hidden_layers + [out]
        self.n_layers = len(widths)
        self.activation = activation
        self.act = mgn_edge.ACTIVATIONS[activation]
        for i, (n_in, n_out) in enumerate(zip([in_features] + widths, widths)):
            self.add_module(f"lin{i}", Dense(n_in, n_out, generator))
        self.ln = nn.LayerNorm(out, eps=LN_EPS) if layer_norm else None

    def layer(self, i: int) -> Dense:
        return getattr(self, f"lin{i}")

    def tail(self, h: torch.Tensor) -> torch.Tensor:
        """The MLP after its first layer's product: ``h`` is that product
        plus its bias, before the activation."""
        for i in range(1, self.n_layers):
            h = self.layer(i)(self.act(h))
        return h if self.ln is None else self.ln(h)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.tail(self.lin0(x))


class GraphNetBlock(nn.Module):
    """One message-passing block with its own edge and node MLPs."""

    def __init__(self, latent: int, hidden_layers: int, generator: torch.Generator):
        super().__init__()
        self.edge_mlp = MLP(3 * latent, latent, latent, hidden_layers, generator)
        self.node_mlp = MLP(2 * latent, latent, latent, hidden_layers, generator)

    def edge_update(self, x: torch.Tensor, e: torch.Tensor, edges: LiveEdges,
                    mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``(e', e + e')``: ``e' = MLP_e([x_s, x_r, e])`` of every live slot,
        times ``mask`` (n, 1), zero on padding slots. Its first layer is
        split per slot of the kernel, the node rows projected here and
        gathered inside ``mgn_edge.edge_update``."""
        L = x.shape[1]
        mlp = self.edge_mlp
        w = mlp.lin0.kernel
        layers = [t for i in range(1, mlp.n_layers) for t in (mlp.layer(i).kernel,
                                                               mlp.layer(i).bias)]
        return mgn_edge.edge_update(
            x @ w[:L], x @ w[L:2 * L], e, w[2 * L:], mlp.lin0.bias, layers, mlp.ln.weight,
            mlp.ln.bias, mask, edges.senders, edges.receivers, edges.block_tile, edges.view,
            edges.tile)

    def node_update(self, x: torch.Tensor, e_new: torch.Tensor,
                    edges: LiveEdges) -> torch.Tensor:
        """``MLP_n([x, Σ_{edges into r} e'])`` of every node."""
        aggr = scatter_add(e_new, edges.receivers, x.shape[0], edges.block_tile,
                           impl="pallas", tile=edges.tile)
        return self.node_mlp(torch.cat([x, aggr], dim=-1))


class MeshGraphNets(nn.Module):
    """Encode-process-decode with unshared blocks (``core_model.py``)."""

    def __init__(
        self,
        latent_size: int = 128,
        message_passing_steps: int = 15,
        hidden_layers: int = 2,
        node_features: int = NODE_FEATURES,
        out_features: int = OUT_FEATURES,
        stats: MGNStats | None = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        L = latent_size
        self.latent_size = latent_size
        self.message_passing_steps = message_passing_steps
        self.node_encoder = MLP(node_features, L, L, hidden_layers, generator)
        self.edge_encoder = MLP(EDGE_FEATURES, L, L, hidden_layers, generator)
        self.blocks = nn.ModuleList(GraphNetBlock(L, hidden_layers, generator)
                                    for _ in range(message_passing_steps))
        self.decoder = MLP(L, L, out_features, hidden_layers, generator, layer_norm=False)
        stats = stats or MGNStats.ones(node_features, out_features)
        for name in ("node_mean", "node_std", "edge_mean", "edge_std", "target_mean",
                     "target_std"):
            self.register_buffer(name, torch.as_tensor(getattr(stats, name), dtype=torch.float32),
                                 persistent=False)

    def forward(self, batch: GraphBatch, halo: object | None = None) -> torch.Tensor:
        """(Np, 2) normalised velocity change of every node of the padded
        batch (padding rows are computed and not read)."""
        if halo is not None:
            raise ValueError("MeshGraphNets runs on one device: edge partitioning (halo) is "
                             "not supported")
        if batch.node_inputs is None:
            raise ValueError("MeshGraphNets reads the batch's node_inputs: pack samples that "
                             "carry them (NodeFieldSample)")
        edges = live_edges(batch)
        with span("mgn.encode", device=True):
            x = self.node_encoder((batch.node_inputs - self.node_mean) / self.node_std)
            e_in = edge_features(batch.pos, edges.senders, edges.receivers)
            e = self.edge_encoder((e_in - self.edge_mean) / self.edge_std)
            mask = edges.mask.to(x.dtype)[:, None]
        for k, block in enumerate(self.blocks):
            with span("mgn.edge", device=True, block=k):
                count("mgn.edge_rows", edges.n)
                e_new, e = block.edge_update(x, e, edges, mask)
            with span("mgn.node", device=True, block=k):
                x = x + block.node_update(x, e_new, edges)
        with span("mgn.decode", device=True):
            return self.decoder(x)


def loss_mask(batch: GraphBatch) -> torch.Tensor:
    """(Np,) the nodes the loss counts: NORMAL or OUTFLOW nodes of the
    graphs that hold nodes (``graph_node_count``)."""
    types = batch.node_inputs[:, VELOCITY:]
    gid = batch.node_gid.long()
    G = batch.n_graphs
    real = (gid < G) & (batch.graph_node_count[gid.clamp(max=G - 1)] > 0)
    return real & ((types[:, NORMAL] + types[:, OUTFLOW]) > 0)


def mgn_loss(batch: GraphBatch, output: torch.Tensor, model: MeshGraphNets) -> torch.Tensor:
    """``cfd_model.py``'s loss: the mean over the loss's nodes
    (``loss_mask``) of Σ_c (target_c − output_c)², the target normalised by
    the model's statistics."""
    target = (batch.node_targets - model.target_mean) / model.target_std
    mask = loss_mask(batch)
    error = ((target - output) ** 2).sum(-1)
    return torch.where(mask, error, 0.0).sum() / mask.sum().clamp(min=1)


def objective(trainer, batch: GraphBatch, training: bool) -> tuple[torch.Tensor, dict]:
    """MeshGraphNets' objective for ``Trainer(objective=...)``, in training
    and in eval alike: (total, {"mse"}) of ``mgn_loss`` of the trainer's
    model, on one device (no ``group``)."""
    if trainer.group is not None:
        raise ValueError("MeshGraphNets trains on one device: Trainer(group=) is not supported")
    total = mgn_loss(batch, trainer.model(batch), trainer.model)
    return total, {"mse": total}
