"""GraphCast in torch.nn: the encoder–processor–decoder of Lam et al.,
"Learning skillful medium-range global weather forecasting" (Science 382,
2023; arXiv:2212.12794), as github.com/google-deepmind/graphcast writes it
(``graphcast.py``, ``deep_typed_graph_net.py``, ``losses.py``), trained on
one autoregressive step. It has no counterpart in the JAX package.

- The graph is fixed: ``graphs/grid_mesh.py::grid_mesh_graph``, node sets
  ``grid`` and ``mesh``, edge sets ``grid2mesh``, ``mesh`` (the multimesh)
  and ``mesh2grid``, each edge with 4 spatial features. A sample
  (``graphs/typed.py::TypedSample``) holds the grid nodes' inputs and
  targets.
- Every MLP is Haiku's ``MLP([L] * hidden_layers + [out])`` with SiLU
  between the layers, then a per-row LayerNorm (eps 1e-5), but for the
  output MLP; Haiku's init: kernels truncated normal (±2 σ) with σ =
  1/√fan_in, biases 0, LayerNorm scale 1 and offset 0
  (``meshgraphnets.MLP``, which is Sonnet's and Haiku's alike).
- An interaction step over an edge set from node set S to node set R:
  ``e' = MLP_e([e, v_s, v_r])``, ``v_r' = MLP_R([v_r, Σ_{edges into r}
  e'])``, then ``v ← v + v'``, ``e ← e + e'``; the sums in fp32.
- Encoder: embed the grid nodes' inputs (the normalised inputs and the 3
  structural features), the mesh nodes' (the published code pads their 3
  structural features with zero columns to the grid's width; the zero
  columns' products are nought and are not computed) and the grid2mesh
  edges, then one step over grid2mesh: the mesh nodes receive, the grid
  nodes are updated by ``MLP([v])`` alone.
- Processor: embed the multimesh edges, then ``message_passing_steps``
  steps over the multimesh, each with its own weights.
- Decoder: embed the mesh2grid edges, one step over mesh2grid into the grid
  nodes, then the output MLP (no LayerNorm): the normalised targets. The
  published decoder also updates the mesh nodes, whose result it does not
  read; that MLP is left out.
- Loss (``losses.weighted_mse_per_level``): ``Σ_v w_v · mean_{i,ℓ}[a_i ·
  w_ℓ · (ŷ − y)²]``, y the target normalised (``GraphCastStats``: a state
  variable's 6-hour change over the std of such changes, the precipitation
  by its mean and std), a_i the latitude weights (each row's cell area,
  the poles' their caps, mean 1), w_ℓ the pressure over its mean over the
  13 levels, w_v 1 but for 10 m u and v, mean sea-level pressure and
  precipitation (0.1). A sample is a batch of one graph: the loss is the
  mean of the samples' losses over those whose graph holds grid nodes
  (``graph_node_count``).

Each edge MLP's first layer over ``[e, v_s, v_r]`` is split per slot of
its kernel: ``v_s·W_s`` once per sender-set row and ``v_r·W_r`` once per
receiver-set row, and the rest of the edge update is
``ops/mgn_edge.py::plain_edge_update``, the plain composition on either
device (MeshGraphNets' hand-written kernel is built for its L = 128 ReLU
MLP, not for this L = 512 SiLU one); every sum over the receivers is
``scatter_add(impl="pallas")`` (#3). ``e'`` is multiplied by the edge
mask, so a padding slot adds nothing to a sum and takes no gradient, and
the loss weights padding rows by 0.

The model runs on one device: edge partitioning (``halo``) raises; no step
is rematerialized. Spans (``utils/profiling``, ``device=True``):
``graphcast.grid2mesh`` (the embedders of the grid, the mesh, the
grid2mesh and the multimesh edges, and the encoder step), ``graphcast.edge``
and ``graphcast.node`` (attribute ``block``) a processor step,
``graphcast.mesh2grid`` (the mesh2grid embedder, the decoder step and the
output MLP); the counters ``graphcast.edge_rows`` and
``graphcast.edge_real_rows`` add each edge update's slots and real edges,
once an edge update in every set.

Importing this module applies the port's matmul precision policy
(``utils/precision.py``: fp32 with TF32 off by default).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from p_div_gnn_tpu_torch.graphs.typed import EdgeSet, NodeSet, TypedSample
from p_div_gnn_tpu_torch.models.meshgraphnets import MLP
from p_div_gnn_tpu_torch.ops import mgn_edge
from p_div_gnn_tpu_torch.ops.scatter import scatter_add
from p_div_gnn_tpu_torch.utils.precision import matmul_precision
from p_div_gnn_tpu_torch.utils.profiling import count, span

matmul_precision()

# graphcast.py's TASK_13_PRECIP_OUT
PRESSURE_LEVELS = (50, 100, 150, 200, 250, 300, 400, 500, 600, 700, 850, 925, 1000)
SURFACE = ("2m_temperature", "mean_sea_level_pressure", "10m_v_component_of_wind",
           "10m_u_component_of_wind")
ATMOSPHERIC = ("temperature", "geopotential", "u_component_of_wind", "v_component_of_wind",
               "vertical_velocity", "specific_humidity")
PRECIPITATION = "total_precipitation_6hr"
FORCINGS = ("toa_incident_solar_radiation", "year_progress_sin", "year_progress_cos",
            "day_progress_sin", "day_progress_cos")
STATIC = ("geopotential_at_surface", "land_sea_mask")
INPUT_TIMES = 2  # t − 6 h and t
FORCING_TIMES = 3  # t − 6 h, t and t + 6 h
STATE = len(SURFACE) + len(ATMOSPHERIC) * len(PRESSURE_LEVELS)  # 82 a time
# the grid nodes' input channels: the state at each input time (surface, then
# each atmospheric variable's levels), the forcings at each time, the statics
INPUTS = INPUT_TIMES * STATE + FORCING_TIMES * len(FORCINGS) + len(STATIC)  # 181
# the targets: the surface state, the precipitation, the atmospheric state
TARGETS = len(SURFACE) + 1 + len(ATMOSPHERIC) * len(PRESSURE_LEVELS)  # 83
PRECIPITATION_CHANNEL = len(SURFACE)
STRUCTURAL = 3  # node features of graphs/grid_mesh.py
EDGE_FEATURES = 4
LOW_WEIGHT = {"mean_sea_level_pressure", "10m_v_component_of_wind", "10m_u_component_of_wind",
              PRECIPITATION}  # w_v 0.1; every other variable 1
STD_EPS = 1e-8


def channel_weights() -> np.ndarray:
    """(TARGETS,) each target channel's weight in the loss: w_v for a surface
    variable, w_v · w_ℓ / 13 for a level of an atmospheric one."""
    w_v = lambda name: 0.1 if name in LOW_WEIGHT else 1.0  # noqa: E731
    levels = np.asarray(PRESSURE_LEVELS, np.float64)
    per_level = levels / levels.mean() / len(levels)
    return np.concatenate([[w_v(v) for v in SURFACE + (PRECIPITATION,)]]
                          + [w_v(v) * per_level for v in ATMOSPHERIC])


def latitude_weights(lat: np.ndarray) -> np.ndarray:
    """Each node's latitude weight (``normalized_latitude_weights`` of a grid
    that holds both poles): cos(lat)·sin(Δ/2), the poles sin(Δ/4)², over
    their mean over the grid's latitudes."""
    rows = np.unique(lat)
    delta = np.diff(rows)
    if not (np.allclose(delta, delta[0]) and np.isclose(rows[0], -90.0)
            and np.isclose(rows[-1], 90.0)):
        raise ValueError("latitude weights need a uniform grid that holds both poles")
    per_row = np.cos(np.deg2rad(rows)) * np.sin(np.deg2rad(delta[0] / 2))
    per_row[[0, -1]] = np.sin(np.deg2rad(delta[0] / 4)) ** 2
    return (per_row / per_row.mean())[np.searchsorted(rows, lat)]


@dataclass(frozen=True)
class GraphCastStats:
    """Fixed per-channel normalisers: the inputs' mean and std (INPUTS,),
    the targets' location and scale (TARGETS,): 0 and the std for a state
    variable's change, the mean and the std for the precipitation."""

    input_mean: np.ndarray
    input_std: np.ndarray
    target_loc: np.ndarray
    target_scale: np.ndarray

    @classmethod
    def ones(cls) -> "GraphCastStats":
        return cls(np.zeros(INPUTS), np.ones(INPUTS), np.zeros(TARGETS), np.ones(TARGETS))


def compute_graphcast_stats(samples: list[TypedSample]) -> GraphCastStats:
    """The normalisers over the samples' real rows, in fp64 (biased stds,
    at least ``STD_EPS``): fixed statistics in place of the published ones
    over ERA5."""
    def rows(name: str) -> np.ndarray:
        return np.concatenate([np.asarray(torch.as_tensor(getattr(s, name))[
            :int(torch.as_tensor(s.graph_node_count).sum())].cpu(), np.float64) for s in samples])

    x, y = rows("inputs"), rows("targets")
    loc = np.zeros(TARGETS)
    loc[PRECIPITATION_CHANNEL] = y[:, PRECIPITATION_CHANNEL].mean()
    return GraphCastStats(x.mean(0), np.maximum(x.std(0), STD_EPS), loc,
                          np.maximum(y.std(0), STD_EPS))


def node_weights(grid: NodeSet, device: torch.device) -> torch.Tensor:
    """(n_padded,) the grid nodes' latitude weights, 0 on padding rows; kept
    on the node set, one copy a device."""
    cached = getattr(grid, "_loss_weights", None)
    if cached is None or cached.device != device:
        w = np.zeros(grid.n_padded, np.float32)
        w[:grid.n] = latitude_weights(grid.lat)
        cached = grid._loss_weights = torch.as_tensor(w, device=device)
    return cached


class Interaction(nn.Module):
    """One interaction step's MLPs over an edge set: the edge MLP over
    ``[e, v_s, v_r]`` and the receiver set's node MLP over ``[v_r, Σ e']``."""

    def __init__(self, latent: int, hidden_layers: int, generator: torch.Generator,
                 activation: str):
        super().__init__()
        self.edge_mlp = MLP(3 * latent, latent, latent, hidden_layers, generator,
                            activation=activation)
        self.node_mlp = MLP(2 * latent, latent, latent, hidden_layers, generator,
                            activation=activation)

    def edge_update(self, x_s: torch.Tensor, x_r: torch.Tensor, e: torch.Tensor,
                    edges: EdgeSet) -> tuple[torch.Tensor, torch.Tensor]:
        """``(e', e + e')`` of every slot, zero on padding slots; the first
        layer split per slot of its kernel."""
        L, mlp = x_s.shape[1], self.edge_mlp
        w = mlp.lin0.kernel
        layers = [t for i in range(1, mlp.n_layers) for t in (mlp.layer(i).kernel,
                                                               mlp.layer(i).bias)]
        count("graphcast.edge_rows", edges.slots)
        count("graphcast.edge_real_rows", edges.n)
        return mgn_edge.plain_edge_update(
            x_s @ w[L:2 * L], x_r @ w[2 * L:], e, w[:L], mlp.lin0.bias, layers, mlp.ln.weight,
            mlp.ln.bias, edges.mask, edges.senders, edges.receivers, edges.block_tile,
            edges.view, edges.tile, activation=mlp.activation)

    def node_update(self, x_r: torch.Tensor, e_new: torch.Tensor,
                    edges: EdgeSet) -> torch.Tensor:
        """``v_r + MLP_R([v_r, Σ_{edges into r} e'])`` of every receiver row."""
        aggr = scatter_add(e_new, edges.receivers, x_r.shape[0], edges.block_tile,
                           impl="pallas", tile=edges.tile)
        return x_r + self.node_mlp(torch.cat([x_r, aggr], dim=-1))


class GraphCast(nn.Module):
    """The encoder, the processor's unshared steps and the decoder."""

    def __init__(
        self,
        latent_size: int = 512,
        message_passing_steps: int = 16,
        hidden_layers: int = 1,
        grid_inputs: int = INPUTS + STRUCTURAL,
        mesh_inputs: int = STRUCTURAL,
        edge_inputs: int = EDGE_FEATURES,
        outputs: int = TARGETS,
        activation: str = "silu",
        stats: GraphCastStats | None = None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        L, h, act = latent_size, hidden_layers, activation
        self.latent_size, self.message_passing_steps = latent_size, message_passing_steps
        self.mesh_inputs = mesh_inputs

        def mlp(n_in: int, out: int = L, layer_norm: bool = True) -> MLP:
            return MLP(n_in, L, out, h, generator, layer_norm=layer_norm, activation=act)

        self.grid_embed = mlp(grid_inputs)
        self.mesh_embed = mlp(grid_inputs)  # the mesh's features zero-padded to the grid's width
        self.grid2mesh_embed = mlp(edge_inputs)
        self.encoder = Interaction(L, h, generator, act)
        self.encoder_grid_node = mlp(L)
        self.mesh_edge_embed = mlp(edge_inputs)
        self.blocks = nn.ModuleList(Interaction(L, h, generator, act)
                                    for _ in range(message_passing_steps))
        self.mesh2grid_embed = mlp(edge_inputs)
        self.decoder = Interaction(L, h, generator, act)
        self.output = mlp(L, outputs, layer_norm=False)
        stats = stats or GraphCastStats.ones()
        for name in ("input_mean", "input_std", "target_loc", "target_scale"):
            self.register_buffer(name, torch.as_tensor(getattr(stats, name), dtype=torch.float32),
                                 persistent=False)
        self.register_buffer("channel_weights", torch.as_tensor(channel_weights(),
                                                                dtype=torch.float32),
                             persistent=False)

    def forward(self, batch: TypedSample, halo: object | None = None) -> torch.Tensor:
        """(n_padded, outputs) normalised targets of every grid row (padding
        rows are computed and not read)."""
        if halo is not None:
            raise ValueError("GraphCast runs on one device: edge partitioning (halo) is not "
                             "supported")
        g = batch.graph
        grid, mesh = g.nodes["grid"], g.nodes["mesh"]
        g2m, mm, m2g = g.edges["grid2mesh"], g.edges["mesh"], g.edges["mesh2grid"]
        with span("graphcast.grid2mesh", device=True):
            x_g = self.grid_embed(torch.cat([(batch.inputs - self.input_mean) / self.input_std,
                                             grid.features], dim=-1))
            emb = self.mesh_embed
            x_m = emb.tail(mesh.features @ emb.lin0.kernel[-self.mesh_inputs:] + emb.lin0.bias)
            e_new, _ = self.encoder.edge_update(x_g, x_m, self.grid2mesh_embed(g2m.features), g2m)
            x_m = self.encoder.node_update(x_m, e_new, g2m)
            x_g = x_g + self.encoder_grid_node(x_g)
            e = self.mesh_edge_embed(mm.features)
        for k, block in enumerate(self.blocks):
            with span("graphcast.edge", device=True, block=k):
                e_new, e = block.edge_update(x_m, x_m, e, mm)
            with span("graphcast.node", device=True, block=k):
                x_m = block.node_update(x_m, e_new, mm)
        with span("graphcast.mesh2grid", device=True):
            e_new, _ = self.decoder.edge_update(x_m, x_g, self.mesh2grid_embed(m2g.features), m2g)
            return self.output(self.decoder.node_update(x_g, e_new, m2g))


def graphcast_loss(batch: TypedSample, output: torch.Tensor, model: GraphCast) -> torch.Tensor:
    """The weighted MSE of the module docstring, over the grid rows of the
    samples whose graph holds nodes (0 where none does)."""
    target = (batch.targets - model.target_loc) / model.target_scale
    error = ((output - target) ** 2 * model.channel_weights).sum(-1)
    weighted = (error * node_weights(batch.graph.nodes[batch.node_set], error.device)).sum()
    nodes = batch.graph_node_count.to(error.dtype)
    held = nodes > 0
    return (torch.where(held, weighted / nodes.clamp(min=1), 0.0).sum()
            / held.sum().clamp(min=1))


def objective(trainer, batch: TypedSample, training: bool) -> tuple[torch.Tensor, dict]:
    """GraphCast's objective for ``Trainer(objective=...)``, in training and
    in eval alike: (total, {"mse"}) of ``graphcast_loss``, on one device."""
    if trainer.group is not None:
        raise ValueError("GraphCast trains on one device: Trainer(group=) is not supported")
    total = graphcast_loss(batch, trainer.model(batch), trainer.model)
    return total, {"mse": total}
