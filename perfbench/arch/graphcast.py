"""GraphCast (Lam et al., Science 2023, arXiv:2212.12794;
github.com/google-deepmind/graphcast, the ``GraphCast_small`` model) as the
fixed-graph training driver (``harness/train_grid.py``) and the yardstick
see it. The contract is ``arch/pdivgnn.py``'s docstring, read for a fixed
graph:

- ``draw_inputs(fixed, seed)``: ``fixed`` is ``{"graph": the port's typed
  graph on the host, "samples": how many}`` in place of a mesh pool; the
  samples are drawn over its grid from the seed;
- ``port_samples`` gives ``TypedSample``s over that one graph;
- ``reference_batch(inputs, ids, device)`` takes one sample id (a batch of
  one) and carries the reference's own graph, built once from the
  configuration's ``graph_spec`` in ``inputs``;
- ``model_flops(cfg, E, N)`` counts a forward over the configuration's
  built graph, its sets' shares of E real edges and N real nodes.

The samples are seeded smooth fields on the sphere in the published
channel layout (``draw_inputs``) in place of ERA5, a download the
repository does not hold. Inputs and targets are stored in fp32; the
program and the reference read the same values.

The port's model is imported with this module, when the configuration is
read: a checkout whose port lacks it stops there.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from p_div_gnn_tpu_torch.graphs.typed import TypedGraph, TypedSample
from p_div_gnn_tpu_torch.models import graphcast as gc
from p_div_gnn_tpu_torch.train import loop
from p_div_gnn_tpu_torch.train.data import FixedGraphLoader

from perfbench.reference import graphcast as ref

REQUIRED_KEYS = ("latent_size", "message_passing_steps", "hidden_layers", "activation",
                 "grid_inputs", "mesh_inputs", "edge_inputs", "outputs", "resolution",
                 "mesh_levels", "radius_query_fraction_edge_length", "batch_size",
                 "stream_dtype", "learning_rate", "betas", "weight_decay", "grad_clip_norm",
                 "remat_steps", "train_samples")

SOLAR_CONSTANT = 1361.0  # W/m²
YEAR_HOURS, DAY_HOURS = 365.25 * 24, 24.0
SPAN_STEPS = 4 * 365 * 4  # the samples' times: 6-hourly over four years


def graph_spec(cfg: dict) -> dict:
    return {"resolution": cfg["resolution"], "mesh_levels": list(cfg["mesh_levels"]),
            "radius_fraction": cfg["radius_query_fraction_edge_length"]}


def _pattern(rng, n: int, lat: np.ndarray, lon: np.ndarray, hours: float) -> np.ndarray:
    """(n, n_lat, n_lon) smooth fields of latitude and longitude at ``hours``:
    two zonal terms, a wave of zonal number 1 and one of 2 drifting east,
    and a seasonal term, each with its amplitude and phase from ``rng``
    (drawn the same for every time: the caller gives one generator state a
    field)."""
    a, b, alpha, beta, kappa = (rng.uniform(lo, hi, (n, 1, 1)) for lo, hi in (
        (-1, 1), (-1, 1), (0.3, 1), (0.3, 1), (0, 0.5)))
    psi1, psi2, psi3 = (rng.uniform(0, 2 * np.pi, (n, 1, 1)) for _ in range(3))
    w1, w2 = (np.deg2rad(rng.uniform(1, 3, (n, 1, 1))) for _ in range(2))  # rad an hour
    phi, lam = np.deg2rad(lat)[None, :, None], np.deg2rad(lon)[None, None, :]
    return (a * np.sin(phi) + b * (1.5 * np.sin(phi) ** 2 - 0.5)
            + alpha * np.cos(phi) * np.cos(lam - w1 * hours + psi1)
            + beta * np.cos(phi) ** 2 * np.sin(2 * lam - w2 * hours + psi2)
            + kappa * np.sin(phi) * np.sin(2 * np.pi * hours / YEAR_HOURS + psi3))


def _forcings(lat: np.ndarray, lon: np.ndarray, hours: float) -> np.ndarray:
    """(5, n_lat, n_lon) the forcings at ``hours``: top-of-atmosphere
    insolation over an hour (J/m²: S0 · max(cos zenith, 0) · 3600, the
    declination of the year's progress), the year's progress' sine and
    cosine, the local day's progress' (UTC hours plus longitude / 15)."""
    year = (hours % YEAR_HOURS) / YEAR_HOURS
    day = ((hours % DAY_HOURS) / DAY_HOURS + lon[None, :] / 360.0) % 1.0
    decl = np.deg2rad(-23.44) * np.cos(2 * np.pi * (year + 10 / 365.25))
    phi = np.deg2rad(lat)[:, None]
    cos_z = np.sin(phi) * np.sin(decl) + np.cos(phi) * np.cos(decl) * np.cos(2 * np.pi * day
                                                                               - np.pi)
    shape = (len(lat), len(lon))
    return np.stack([SOLAR_CONSTANT * 3600 * np.maximum(cos_z, 0.0),
                     np.full(shape, np.sin(2 * np.pi * year)),
                     np.full(shape, np.cos(2 * np.pi * year)),
                     np.sin(2 * np.pi * day) * np.ones(shape),
                     np.cos(2 * np.pi * day) * np.ones(shape)])


def draw_inputs(fixed: dict, seed: int) -> dict:
    """``fixed["samples"]`` samples over the graph's grid, each (n_padded,
    181) inputs and (n_padded, 83) targets in fp32, zero on padding rows.

    Each of the 82 state channels is ``m + s · pattern`` (``_pattern``), m
    over [−2, 2] and s log-uniform over [0.1, 10] from the seed, the
    pattern's amplitudes and phases from the seed, the same at every time
    (so the change over 6 hours is the pattern's drift); the
    precipitation is ``s_p (1 + pattern / 3)²``. Each sample takes a time
    from the seed, 6-hourly over four years: inputs the state at t − 6 h and
    t, the forcings (``_forcings``) at t − 6 h, t and t + 6 h, and the two
    static fields (seeded smooth fields: the surface geopotential
    ``2e4 · max(pattern, 0)``, the land-sea mask ``sigmoid(4 · pattern)``);
    targets the state's change from t to t + 6 h and the precipitation at t
    + 6 h. Every channel's spread over the samples stays away from nought."""
    grid: TypedGraph = fixed["graph"]
    lat, lon = np.unique(grid.nodes["grid"].lat), np.unique(grid.nodes["grid"].lon)
    rng = np.random.default_rng([seed, 26])
    mean, scale = rng.uniform(-2, 2, (gc.STATE, 1, 1)), np.exp(rng.uniform(np.log(0.1), np.log(
        10.0), (gc.STATE, 1, 1)))
    precip_scale = rng.uniform(0.5, 2.0)
    state_seed, precip_seed, static_seed = (int(x) for x in rng.integers(0, 2**62, 3))
    statics = np.stack([2e4 * np.maximum(_pattern(np.random.default_rng(static_seed), 1, lat, lon,
                                                  0.0)[0], 0.0),
                        1 / (1 + np.exp(-4 * _pattern(np.random.default_rng(static_seed + 1), 1,
                                                      lat, lon, 0.0)[0]))])
    times = 6.0 * rng.choice(SPAN_STEPS, size=fixed["samples"], replace=False)
    n, n_padded = grid.nodes["grid"].n, grid.nodes["grid"].n_padded

    def state(hours: float) -> np.ndarray:
        return mean + scale * _pattern(np.random.default_rng(state_seed), gc.STATE, lat, lon, hours)

    def rows(parts: list[np.ndarray], width: int) -> np.ndarray:
        out = np.zeros((n_padded, width), np.float32)
        out[:n] = np.concatenate([p.reshape(len(p), -1) for p in parts]).T
        return out

    inputs, targets = [], []
    for t in times:
        before, now, after = state(t - 6), state(t), state(t + 6)
        precip = precip_scale * (1 + _pattern(np.random.default_rng(precip_seed), 1, lat, lon,
                                              t + 6) / 3) ** 2
        change = after - now
        inputs.append(rows([before, now] + [_forcings(lat, lon, t + dt) for dt in (-6, 0, 6)]
                           + [statics], gc.INPUTS))
        targets.append(rows([change[:len(gc.SURFACE)], precip, change[len(gc.SURFACE):]],
                            gc.TARGETS))
    return {"inputs": inputs, "targets": targets}


def port_samples(inputs: dict) -> list[TypedSample]:
    count = np.array([inputs["graph"].nodes["grid"].n], np.int32)
    return [TypedSample(inputs["graph"], x, y, count)
            for x, y in zip(inputs["inputs"], inputs["targets"])]


def parameter_spec(cfg: dict) -> list[tuple[str, tuple, int | str]]:
    """(name, shape, init) of every parameter, named as the port names them:
    init is a kernel's fan-in, or "ones" / "zeros"."""
    L, layers = cfg["latent_size"], cfg["hidden_layers"]
    spec: list = []

    def mlp(prefix: str, n_in: int, out: int = L, layer_norm: bool = True) -> None:
        widths = [L] * layers + [out]
        for i, (fan, width) in enumerate(zip([n_in] + widths, widths)):
            spec.extend([(f"{prefix}.lin{i}.kernel", (fan, width), fan),
                         (f"{prefix}.lin{i}.bias", (width,), "zeros")])
        if layer_norm:
            spec.extend([(f"{prefix}.ln.weight", (out,), "ones"),
                         (f"{prefix}.ln.bias", (out,), "zeros")])

    def interaction(prefix: str) -> None:
        mlp(f"{prefix}.edge_mlp", 3 * L)
        mlp(f"{prefix}.node_mlp", 2 * L)

    mlp("grid_embed", cfg["grid_inputs"])
    mlp("mesh_embed", cfg["grid_inputs"])
    mlp("grid2mesh_embed", cfg["edge_inputs"])
    interaction("encoder")
    mlp("encoder_grid_node", L)
    mlp("mesh_edge_embed", cfg["edge_inputs"])
    for k in range(cfg["message_passing_steps"]):
        interaction(f"blocks.{k}")
    mlp("mesh2grid_embed", cfg["edge_inputs"])
    interaction("decoder")
    mlp("output", L, cfg["outputs"], layer_norm=False)
    return spec


def draw_weights(cfg: dict, seed: int, device) -> dict:
    """Haiku's init from the seed, on the device, in one draw: every kernel
    truncated normal (±2 σ) with σ = 1/√fan_in, biases 0, LayerNorm scale 1
    and offset 0."""
    spec = parameter_spec(cfg)
    total = sum(math.prod(shape) for _, shape, init in spec if isinstance(init, int))
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = torch.nn.init.trunc_normal_(torch.empty(total, device=device), 0.0, 1.0, -2.0, 2.0,
                                       generator=gen)
    out, at = {}, 0
    for name, shape, init in spec:
        if init == "ones":
            out[name] = torch.ones(shape, device=device)
        elif init == "zeros":
            out[name] = torch.zeros(shape, device=device)
        else:
            n = math.prod(shape)
            out[name] = (draw[at:at + n] / math.sqrt(init)).reshape(shape)
            at += n
    return out


def build_program(cfg: dict, traffic: dict, inputs: dict, initial: dict, device) -> tuple:
    """The port's ``GraphCast`` with the samples' fixed normalisers, a
    ``Trainer`` on its objective with the published AdamW and clipping, and
    a ``FixedGraphLoader`` over the samples with the traffic's loader seed."""
    if cfg["remat_steps"] or cfg["stream_dtype"] != "float32" or cfg["batch_size"] != 1:
        raise ValueError("GraphCast runs one fp32 sample a step, without remat")
    samples = port_samples(inputs)
    model = gc.GraphCast(
        latent_size=cfg["latent_size"], message_passing_steps=cfg["message_passing_steps"],
        hidden_layers=cfg["hidden_layers"], grid_inputs=cfg["grid_inputs"],
        mesh_inputs=cfg["mesh_inputs"], edge_inputs=cfg["edge_inputs"],
        outputs=cfg["outputs"], activation=cfg["activation"],
        stats=gc.compute_graphcast_stats(samples))
    model.load_state_dict(initial)
    trainer = loop.Trainer(model=model, learning_rate=cfg["learning_rate"],
                           objective=gc.objective, device=device, betas=tuple(cfg["betas"]),
                           weight_decay=cfg["weight_decay"], clip_norm=cfg["grad_clip_norm"])
    trainer.init()
    loader = FixedGraphLoader(samples, shuffle=True, seed=inputs["loader_seed"], device=device)
    return trainer, loader


def reference_stats(inputs: dict) -> dict:
    n = inputs["graph"].nodes["grid"].n
    return ref.normalisers([torch.as_tensor(x[:n]) for x in inputs["inputs"]],
                           [torch.as_tensor(y[:n]) for y in inputs["targets"]],
                           gc.PRECIPITATION_CHANNEL)


def reference_graph(inputs: dict, device) -> ref.Graph:
    """The reference's own graph, built once a device and kept in ``inputs``."""
    built = inputs.setdefault("reference_graphs", {})
    key = str(device)
    if key not in built:
        spec = inputs["graph_spec"]
        built[key] = ref.build_graph(spec["resolution"], spec["mesh_levels"],
                                     spec["radius_fraction"], device)
    return built[key]


def reference_batch(inputs: dict, ids, device) -> ref.Batch:
    (i,) = ids
    n = inputs["graph"].nodes["grid"].n
    t = lambda a: torch.as_tensor(a[:n], device=device).double()  # noqa: E731
    return ref.Batch(t(inputs["inputs"][i]), t(inputs["targets"][i]),
                     reference_graph(inputs, device))


def reference_loss(params: dict, batch, stats: dict, cfg: dict, stream):
    if stream is not None:
        raise ValueError("the GraphCast reference has no stream rounding")
    return ref.loss(params, batch, {k: v.to(batch.inputs.device) for k, v in stats.items()},
                    cfg["message_passing_steps"], cfg["hidden_layers"], remat=True)


def model_flops(cfg: dict, E: int, N: int) -> tuple[float, float]:
    """(edge-stream FLOPs, other FLOPs) of one forward in the least form the
    port runs: each edge MLP's first layer split per slot, ``e·W_e`` and the
    later layers per real edge, the sender and receiver projections once
    per real node of their sets; the embedders, the node MLPs and the
    output MLP per real node or edge; the mesh embedder over its 3 nonzero
    input columns. The sets' sizes are the configuration's built counts
    (``graph``), scaled to E real edges and N real nodes."""
    L, S, h = cfg["latent_size"], cfg["message_passing_steps"], cfg["hidden_layers"]
    built = cfg["graph"]
    e_scale = E / (built["grid2mesh_edges"] + built["mesh_edges"] + built["mesh2grid_edges"])
    n_scale = N / (built["grid_nodes"] + built["mesh_nodes"])
    g2m, mm, m2g = (built[f"{k}_edges"] * e_scale for k in ("grid2mesh", "mesh", "mesh2grid"))
    ng, nm = built["grid_nodes"] * n_scale, built["mesh_nodes"] * n_scale

    def mlp(n_in: int, out: int = L) -> int:
        widths = [L] * h + [out]
        return 2 * sum(a * b for a, b in zip([n_in] + widths, widths))

    edge_rows = mlp(L) - 2 * L * L  # e·W_e as its first layer's share, and the later layers
    proj = 2 * L * L
    stream = (g2m + S * mm + m2g) * (2 * L * L + edge_rows)
    other = (proj * (ng + nm) + S * proj * 2 * nm + proj * (nm + ng)  # the node projections
             + ng * mlp(cfg["grid_inputs"]) + nm * mlp(cfg["mesh_inputs"])
             + (g2m + mm + m2g) * mlp(cfg["edge_inputs"])
             + nm * mlp(2 * L) + ng * mlp(L) + S * nm * mlp(2 * L) + ng * mlp(2 * L)
             + ng * mlp(L, cfg["outputs"]))
    return float(stream), float(other)


def fault_sites() -> dict[str, tuple[object, str]]:
    return {"step": (loop.Trainer, "train_step"), "loss": (gc, "graphcast_loss"),
            "output": (gc.GraphCast, "forward")}
