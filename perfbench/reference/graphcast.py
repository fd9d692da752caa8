"""The plain reference of GraphCast (Lam et al., Science 2023,
arXiv:2212.12794; github.com/google-deepmind/graphcast ``graphcast.py``,
``deep_typed_graph_net.py``, ``icosahedral_mesh.py``,
``grid_mesh_connectivity.py``, ``model_utils.py``, ``losses.py``), written
from the published equations in plain PyTorch: its own graph, real nodes
and edges only, no padding, no kernels, no program code.

- The graph (``build_graph``), from the configuration's resolution, mesh
  levels and radius fraction: the icosahedron in the published orientation
  (vertices ``(±1, ±φ, 0)`` and their cyclic shifts, normalised, times the
  y rotation by (π − dihedral) / 2), its faces the triples of pairwise
  nearest vertices, each level's faces split in four at the normalised
  midpoints (a midpoint cache, face by face); the multimesh: every side of
  the chosen levels, both directions; the grid: latitudes −90 .. 90,
  longitudes from 0, latitude-major; grid2mesh: every (grid, mesh) pair
  within the radius, by brute force; mesh2grid: the three vertices of the
  finest face whose cone holds the grid node, by brute force over every
  face (a node on a shared side or vertex, within ``TIE``, goes to the face
  whose vertices' sum lies farthest along ``TIE_DIRECTION``).
- Features: a node's ``[sin lat, cos lon, sin lon]``; an edge's ``[|d|,
  d] / max |d|`` over its set, d the sender less the receiver written in
  the receiver's radial, east and north unit vectors.
- ``mlp``: Linear → SiLU → ... → Linear, then ``layer_norm`` per row (eps
  1e-5) but on the output MLP. An interaction step: ``e' = mlp([e, v_s,
  v_r])`` with ``index_select``, ``v_r' = mlp([v_r, Σ e'])`` with
  ``index_add_``, ``v += v'``, ``e += e'``. The mesh nodes' input is their 3
  features after zero columns up to the grid's width, as published.
- Loss: ``Σ_v w_v · mean over grid nodes (and levels) of a_i · w_ℓ · (ŷ −
  y)²`` (``loss``), with the latitude weights, pressure weights and
  variable weights of ``losses.py``.
- ``adamw_clip_update``: the gradients scaled to a global norm of at most
  ``clip``, then AdamW (``optax.adamw``: eps 1e-8 outside the square root,
  bias correction, the decay ``lr · wd · p``).

Parameters are taken by the port's names, in the dtype to compute in: the
benchmark runs it in fp64 with TF32 off. With ``remat`` each processor
step is recomputed in the backward (``torch.utils.checkpoint``), so that it
fits on the card.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

LN_EPS = 1e-5
STD_EPS = 1e-8
LEVELS = (50, 100, 150, 200, 250, 300, 400, 500, 600, 700, 850, 925, 1000)
# the target channels: surface variables, precipitation, then 6 atmospheric
# variables of 13 levels each; the variable weight of each
SURFACE_WEIGHTS = (1.0, 0.1, 0.1, 0.1)  # 2 m temperature, mslp, 10 m v, 10 m u
PRECIPITATION_WEIGHT = 0.1
ATMOSPHERIC = 6
CHUNK = 1024  # grid nodes a pass of the brute-force searches
TIE = 1e-9
TIE_DIRECTION = (1.0, 2.0, 3.0)


@dataclass
class Graph:
    """The reference's graph: node positions and features, and each edge
    set's (senders, receivers, features)."""

    grid_lat: torch.Tensor  # (Ng,) degrees
    grid_features: torch.Tensor  # (Ng, 3)
    mesh_features: torch.Tensor  # (Nm, 3)
    edges: dict  # name -> (senders (E,) i64, receivers (E,) i64, features (E, 4))

    def counts(self) -> dict[str, int]:
        return {"grid_nodes": len(self.grid_lat), "mesh_nodes": len(self.mesh_features),
                **{f"{k}_edges": len(v[0]) for k, v in self.edges.items()}}


@dataclass
class Batch:
    """One sample's grid rows over the reference's graph."""

    inputs: torch.Tensor  # (Ng, 181) raw
    targets: torch.Tensor  # (Ng, 83) raw
    graph: Graph


def _icosahedron() -> tuple[torch.Tensor, list[tuple[int, int, int]]]:
    phi = (1 + 5 ** 0.5) / 2
    base = [(1.0, phi, 0.0), (1.0, -phi, 0.0), (-1.0, phi, 0.0), (-1.0, -phi, 0.0)]
    v = torch.tensor([(a, b, c) for a, b, c in base] + [(c, a, b) for a, b, c in base]
                     + [(b, c, a) for a, b, c in base], dtype=torch.float64)
    v = v / math.hypot(1.0, phi)
    angle = (math.pi - 2 * math.asin(phi / math.sqrt(3))) / 2
    c, s = math.cos(angle), math.sin(angle)
    v = v @ torch.tensor([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], dtype=torch.float64)
    d = torch.cdist(v, v)
    side = float(d[d > 1e-9].min())
    near = (d - side).abs() < 1e-9
    faces = [f for f in itertools.combinations(range(12), 3)
             if near[f[0], f[1]] and near[f[0], f[2]] and near[f[1], f[2]]]
    return v, faces


def _split(v: list, faces: list) -> list:
    cache: dict = {}

    def mid(a: int, b: int) -> int:
        key = (min(a, b), max(a, b))
        if key not in cache:
            m = v[a] + v[b]
            v.append(m / m.norm())
            cache[key] = len(v) - 1
        return cache[key]

    out = []
    for a, b, c in faces:
        ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
        out += [(a, ab, ca), (ab, b, bc), (ca, bc, c), (ab, bc, ca)]
    return out


def _lat_lon(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.rad2deg(torch.asin(x[:, 2].clamp(-1, 1))),
            torch.remainder(torch.rad2deg(torch.atan2(x[:, 1], x[:, 0])), 360.0))


def _xyz(lat: torch.Tensor, lon: torch.Tensor) -> torch.Tensor:
    la, lo = torch.deg2rad(lat), torch.deg2rad(lon)
    return torch.stack([la.cos() * lo.cos(), la.cos() * lo.sin(), la.sin()], dim=1)


def _node_features(lat: torch.Tensor, lon: torch.Tensor) -> torch.Tensor:
    la, lo = torch.deg2rad(lat), torch.deg2rad(lon)
    return torch.stack([la.sin(), lo.cos(), lo.sin()], dim=1)


def _edge_features(s_lat, s_lon, r_lat, r_lon, snd, rcv) -> torch.Tensor:
    d = _xyz(s_lat, s_lon)[snd] - _xyz(r_lat, r_lon)[rcv]
    la, lo = torch.deg2rad(r_lat)[rcv], torch.deg2rad(r_lon)[rcv]
    radial = torch.stack([la.cos() * lo.cos(), la.cos() * lo.sin(), la.sin()], dim=1)
    east = torch.stack([-lo.sin(), lo.cos(), torch.zeros_like(lo)], dim=1)
    north = torch.stack([-la.sin() * lo.cos(), -la.sin() * lo.sin(), la.cos()], dim=1)
    local = torch.stack([(d * radial).sum(1), (d * east).sum(1), (d * north).sum(1)], dim=1)
    length = local.norm(dim=1, keepdim=True)
    return torch.cat([length, local], dim=1) / length.max()


def build_graph(resolution: float, mesh_levels: list[int], radius_fraction: float,
                device: str | torch.device = "cpu") -> Graph:
    """The reference's graph (the module docstring), in fp64 on ``device``."""
    v0, faces = _icosahedron()
    verts = list(v0)
    by_level = [faces]
    for _ in range(max(mesh_levels)):
        by_level.append(_split(verts, by_level[-1]))
    mesh = torch.stack(verts).to(device)
    sides = {}
    for k in mesh_levels:
        for a, b, c in by_level[k]:
            for s, r in ((a, b), (b, c), (c, a)):
                sides[(min(s, r), max(s, r))] = True
    und = torch.tensor(sorted(sides), dtype=torch.long, device=device)
    mm = (torch.cat([und[:, 0], und[:, 1]]), torch.cat([und[:, 1], und[:, 0]]))
    finest = torch.tensor(by_level[-1], dtype=torch.long, device=device)
    longest = float(torch.stack([(mesh[finest[:, i]] - mesh[finest[:, (i + 1) % 3]]).norm(dim=1)
                                 for i in range(3)]).max())
    n_lat, n_lon = round(180 / resolution) + 1, round(360 / resolution)
    lat = torch.linspace(-90.0, 90.0, n_lat, dtype=torch.float64, device=device)
    lon = torch.arange(n_lon, dtype=torch.float64, device=device) * resolution
    g_lat, g_lon = lat.repeat_interleave(n_lon), lon.repeat(n_lat)
    grid = _xyz(g_lat, g_lon)
    inverse = torch.linalg.inv(mesh[finest].transpose(1, 2))  # (F, 3, 3): p -> cone coordinates
    along = mesh[finest].sum(dim=1) @ torch.tensor(TIE_DIRECTION, dtype=torch.float64,
                                                   device=device)
    g2m_g, g2m_m, m2g_face = [], [], []
    radius = radius_fraction * longest
    for start in range(0, len(grid), CHUNK):
        p = grid[start:start + CHUNK]
        i, j = torch.nonzero((p[:, None, :] - mesh[None]).norm(dim=-1) <= radius, as_tuple=True)
        g2m_g.append(i + start)
        g2m_m.append(j)
        holds = torch.einsum("fij,pj->pfi", inverse, p).min(dim=2).values >= -TIE
        m2g_face.append(torch.where(holds, along, -math.inf).argmax(dim=1))
    g2m = (torch.cat(g2m_g), torch.cat(g2m_m))
    m2g_mesh = finest[torch.cat(m2g_face)].reshape(-1)
    m2g = (m2g_mesh, torch.arange(len(grid), device=device).repeat_interleave(3))
    m_lat, m_lon = _lat_lon(mesh)
    edges = {"grid2mesh": (*g2m, _edge_features(g_lat, g_lon, m_lat, m_lon, *g2m)),
             "mesh": (*mm, _edge_features(m_lat, m_lon, m_lat, m_lon, *mm)),
             "mesh2grid": (*m2g, _edge_features(m_lat, m_lon, g_lat, g_lon, *m2g))}
    return Graph(g_lat, _node_features(g_lat, g_lon), _node_features(m_lat, m_lon), edges)


def normalisers(inputs: list[torch.Tensor], targets: list[torch.Tensor],
                precipitation: int) -> dict[str, torch.Tensor]:
    """Per-channel input mean and std, target location (0, but the
    precipitation's mean) and scale (std), biased, at least ``STD_EPS``, in
    fp64 over the given samples."""
    x = torch.cat([t.double() for t in inputs])
    y = torch.cat([t.double() for t in targets])
    loc = torch.zeros(y.shape[1], dtype=torch.float64)
    loc[precipitation] = y[:, precipitation].mean()
    return {"input_mean": x.mean(0), "input_std": x.std(0, unbiased=False).clamp(min=STD_EPS),
            "target_loc": loc, "target_scale": y.std(0, unbiased=False).clamp(min=STD_EPS)}


def mlp(p: dict, prefix: str, x: torch.Tensor, layers: int,
        layer_norm: bool = True) -> torch.Tensor:
    for i in range(layers):
        x = x @ p[f"{prefix}.lin{i}.kernel"] + p[f"{prefix}.lin{i}.bias"]
        if i < layers - 1:
            x = F.silu(x)
    if not layer_norm:
        return x
    return F.layer_norm(x, (x.shape[-1],), p[f"{prefix}.ln.weight"], p[f"{prefix}.ln.bias"],
                        LN_EPS)


def interaction(p: dict, prefix: str, layers: int, x_s: torch.Tensor, x_r: torch.Tensor,
                e: torch.Tensor, snd: torch.Tensor, rcv: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(v_r + v_r', e + e') of one interaction step."""
    e_new = mlp(p, f"{prefix}.edge_mlp", torch.cat([e, x_s.index_select(0, snd),
                                                    x_r.index_select(0, rcv)], dim=-1), layers)
    summed = torch.zeros_like(x_r).index_add_(0, rcv, e_new)
    return x_r + mlp(p, f"{prefix}.node_mlp", torch.cat([x_r, summed], dim=-1), layers), e + e_new


def forward(p: dict, batch: Batch, stats: dict, steps: int, hidden_layers: int,
            remat: bool = False) -> torch.Tensor:
    """(Ng, 83) normalised targets of the grid nodes."""
    graph = batch.graph
    dt = p["output.lin0.kernel"].dtype
    layers = hidden_layers + 1
    s = {k: v.to(dt) for k, v in stats.items()}
    x = (batch.inputs.to(dt) - s["input_mean"]) / s["input_std"]
    x_g = mlp(p, "grid_embed", torch.cat([x, graph.grid_features.to(dt)], dim=-1), layers)
    pad = torch.zeros((len(graph.mesh_features), x.shape[1]), dtype=dt, device=x.device)
    x_m = mlp(p, "mesh_embed", torch.cat([pad, graph.mesh_features.to(dt)], dim=-1), layers)
    snd, rcv, feats = graph.edges["grid2mesh"]
    x_m, _ = interaction(p, "encoder", layers, x_g, x_m,
                         mlp(p, "grid2mesh_embed", feats.to(dt), layers), snd, rcv)
    x_g = x_g + mlp(p, "encoder_grid_node", x_g, layers)
    snd, rcv, feats = graph.edges["mesh"]
    e = mlp(p, "mesh_edge_embed", feats.to(dt), layers)
    for k in range(steps):
        args = (p, f"blocks.{k}", layers, x_m, x_m, e, snd, rcv)
        if remat and torch.is_grad_enabled():
            x_m, e = checkpoint(interaction, *args, use_reentrant=False)
        else:
            x_m, e = interaction(*args)
    snd, rcv, feats = graph.edges["mesh2grid"]
    x_g, _ = interaction(p, "decoder", layers, x_m, x_g,
                         mlp(p, "mesh2grid_embed", feats.to(dt), layers), snd, rcv)
    return mlp(p, "output", x_g, layers, layer_norm=False)


def channel_weights(dtype: torch.dtype, device) -> torch.Tensor:
    """(83,) w_v of each surface channel, w_v · (level / mean level) / 13 of
    each atmospheric level."""
    levels = torch.tensor(LEVELS, dtype=dtype, device=device)
    per_level = levels / levels.mean() / len(LEVELS)
    head = torch.tensor(SURFACE_WEIGHTS + (PRECIPITATION_WEIGHT,), dtype=dtype, device=device)
    return torch.cat([head, per_level.repeat(ATMOSPHERIC)])


def latitude_weights(lat: torch.Tensor) -> torch.Tensor:
    """Each node's cell-area weight, the poles' their caps, mean 1 over the
    latitudes."""
    rows = torch.unique(lat)
    half = torch.deg2rad(rows[1] - rows[0]) / 2
    w = torch.cos(torch.deg2rad(rows)) * torch.sin(half)
    w[0] = w[-1] = torch.sin(half / 2) ** 2
    return (w / w.mean())[torch.searchsorted(rows, lat)]


def loss(p: dict, batch: Batch, stats: dict, steps: int, hidden_layers: int,
         remat: bool = False) -> torch.Tensor:
    out = forward(p, batch, stats, steps, hidden_layers, remat)
    dt = out.dtype
    target = (batch.targets.to(dt) - stats["target_loc"].to(dt)) / stats["target_scale"].to(dt)
    err = (out - target) ** 2 * latitude_weights(batch.graph.grid_lat).to(dt)[:, None]
    return (err.mean(0) * channel_weights(dt, out.device)).sum()


def adamw_clip_update(p: dict, grads: dict, state: dict, lr: float, betas: tuple[float, float],
                      weight_decay: float, clip: float, eps: float = 1e-8) -> dict:
    """One step in place: the gradients scaled to a global norm of at most
    ``clip``, then AdamW; ``state`` {name: (m, v)} and ``"t"``. Returns the
    scaled gradients."""
    b1, b2 = betas
    t = state.get("t", 0) + 1
    state["t"] = t
    with torch.no_grad():
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        scale = clip / torch.clamp(norm, min=clip)
        clipped = {k: g * scale.to(g.dtype) for k, g in grads.items()}
        for name, g in clipped.items():
            m, v = state.get(name, (torch.zeros_like(g), torch.zeros_like(g)))
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            state[name] = (m, v)
            step = (m / (1 - b1 ** t)) / ((v / (1 - b2 ** t)).sqrt() + eps)
            p[name] -= lr * (step + weight_decay * p[name])
    return clipped
