"""GraphCast on the port's training path (``models/graphcast.py``) and its
typed graph (``graphs/icosahedral.py``, ``graphs/grid_mesh.py``,
``graphs/typed.py``) against the plain reference the benchmark holds it to
(``perfbench/reference/graphcast.py``, plain torch in fp64, which builds
its own graph), at a small size: mesh levels 1-2, a 10° grid, L = 16, 2
processor steps. Also: the shared edge update with two node sets and SiLU
against autograd through the plain composition, and its route by shape;
``Trainer``'s AdamW with clipping against the reference's update and its
defaults bit-equal to Adam; the fixed-graph loader's order; the spans and
counters; the benchmark's cell at a tiny size with its faults, and the
readers of its metrics."""

from __future__ import annotations

import contextlib
import time

import numpy as np
import pytest
import torch

from p_div_gnn_tpu_torch.graphs import grid_mesh as gm
from p_div_gnn_tpu_torch.graphs import icosahedral as ico
from p_div_gnn_tpu_torch.graphs.container import NODE_TILE
from p_div_gnn_tpu_torch.graphs.typed import TypedSample
from p_div_gnn_tpu_torch.models import graphcast as gc
from p_div_gnn_tpu_torch.ops import mgn_edge
from p_div_gnn_tpu_torch.ops.gather import sender_gather_one
from p_div_gnn_tpu_torch.ops.segment import runs_are_consecutive
from p_div_gnn_tpu_torch.train.data import FixedGraphLoader, prefetch
from p_div_gnn_tpu_torch.train.loop import Trainer
from p_div_gnn_tpu_torch.utils import profiling
from perfbench.arch import graphcast as arch
from perfbench.harness import registry, train, train_grid
from perfbench.harness.compare import judged, limits
from perfbench.harness.faults import FAULTS, planted
from perfbench.harness.yardstick import Run
from perfbench.reference import graphcast as ref

RES, LEVELS, FRACTION = 10.0, [1, 2], 0.6
L, STEPS, LR = 16, 2, 1e-3
BETAS, DECAY = (0.9, 0.95), 0.1
SEED = 2**31 + 26
CFG = {"latent_size": L, "message_passing_steps": STEPS, "hidden_layers": 1,
       "grid_inputs": gc.INPUTS + gc.STRUCTURAL, "mesh_inputs": gc.STRUCTURAL,
       "edge_inputs": gc.EDGE_FEATURES, "outputs": gc.TARGETS}
# Tolerances of the fp32 program against the fp64 reference, each a
# relative error (fp32's unit round-off is 6e-8, bfloat16's 3.9e-3):
# - loss: the weighted mean of squares over 684 grid nodes and 83 channels
#   after ~25 fp32 layers (embedders, the encoder's and decoder's steps, 2
#   processor steps, the output MLP) with LayerNorms between them, read
#   ~5e-8; 1e-6;
# - gradient: each parameter's gap norm over its reference norm, read
#   under 5e-6 (the backward runs the chains again and adds the sums over
#   edges and nodes); 1e-4; the mesh embedder's rows of the zero input
#   columns take no gradient on either side, which the norm holds;
# - AdamW step with clipping: on the entries whose reference gradient is
#   over 1e-3 of the leaf's largest, the step's gap over the learning rate:
#   a first step moves an entry by lr·(g/(|g| + eps) + wd·p), through the
#   gradient only by its sign where |g| >> eps, so what is left is the
#   rounding of the stepped parameter to fp32 (6e-8 of a LayerNorm scale's
#   1 is 6e-5 of lr); 1e-3.
TOL = {"loss": 1e-6, "gradient": 1e-4, "adamw": 1e-3}


@pytest.fixture(scope="module")
def graph():
    return gm.grid_mesh_graph(RES, LEVELS, FRACTION)


@pytest.fixture(scope="module")
def inputs(graph):
    spec = {"resolution": RES, "mesh_levels": LEVELS, "radius_fraction": FRACTION}
    return {"graph": graph, "graph_spec": spec, "seed": SEED, "loader_seed": 69,
            **arch.draw_inputs({"graph": graph, "samples": 4}, SEED)}


def cone_coordinates(p: np.ndarray, tri: np.ndarray) -> np.ndarray:
    """(3,) coordinates of the point p in the cone of the triangle's rows,
    summing to at least 1 inside it."""
    return np.linalg.solve(tri.T, p)


# --- the graph


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_hierarchy_counts(level):
    """Level k: 10·4^k + 2 vertices on the unit sphere, 20·4^k faces
    oriented outwards, 30·4^k sides each in both directions; a level's
    vertices are the next level's first."""
    meshes = ico.hierarchy(level + 1)
    m = meshes[level]
    assert len(m.vertices) == 10 * 4**level + 2 and len(m.faces) == 20 * 4**level
    np.testing.assert_allclose(np.linalg.norm(m.vertices, axis=1), 1.0, atol=1e-15)
    v = m.vertices[m.faces]
    assert (np.einsum("fi,fi->f", np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]),
                      v[:, 0]) > 0).all()
    s, r = ico.faces_to_edges(m.faces)
    pairs = set(zip(s.tolist(), r.tolist()))
    assert len(pairs) == len(s) == 60 * 4**level and all((b, a) in pairs for a, b in pairs)
    assert np.array_equal(meshes[level + 1].vertices[:len(m.vertices)], m.vertices)


def test_published_orientation():
    """The icosahedron has a face, not a vertex or a side, at each pole."""
    m = ico.icosahedron()
    centres = m.vertices[m.faces].mean(axis=1)
    z = centres[:, 2] / np.linalg.norm(centres, axis=1)
    assert np.isclose(z.max(), 1.0) and np.isclose(z.min(), -1.0)
    assert np.abs(m.vertices[:, 2]).max() < 0.8


def test_graph_counts(graph):
    """The node and edge counts against the formulas; grid2mesh as the
    radius query finds it."""
    counts = graph.counts()
    n_grid = (round(180 / RES) + 1) * round(360 / RES)
    assert counts["grid_nodes"] == n_grid == 684
    assert counts["mesh_nodes"] == 10 * 4 ** max(LEVELS) + 2
    assert counts["mesh_edges"] == 2 * 30 * sum(4**k for k in LEVELS)
    assert counts["mesh2grid_edges"] == 3 * n_grid
    for nodes in graph.nodes.values():
        assert nodes.n_padded % NODE_TILE == 0 and nodes.n_padded > nodes.n
        assert not nodes.features[nodes.n:].any()


def test_mesh2grid_senders_hold_their_grid_node(graph):
    """Each grid node's 3 mesh2grid senders are the vertices of a finest
    face whose cone holds it: barycentric coordinates of the ray's crossing
    of that face all at least -1e-9."""
    e, mesh, grid = graph.edges["mesh2grid"], graph.nodes["mesh"], graph.nodes["grid"]
    xyz_m, xyz_g = gm.to_xyz(mesh.lat, mesh.lon), gm.to_xyz(grid.lat, grid.lon)
    faces = {tuple(sorted(f)) for f in ico.hierarchy(max(LEVELS))[-1].faces.tolist()}
    senders = {}
    for s, r in zip(e.senders[e.real], e.receivers[e.real]):
        senders.setdefault(int(r), []).append(int(s))
    assert sorted(senders) == list(range(grid.n))
    for node, tri in senders.items():
        assert tuple(sorted(tri)) in faces
        c = cone_coordinates(xyz_g[node], xyz_m[tri])
        assert (c / c.sum() >= -1e-9).all(), (node, c)


def test_grid2mesh_is_the_radius_search(graph):
    """grid2mesh against a brute-force search of every (grid, mesh) pair
    within 0.6 of the finest level's longest side."""
    mesh, grid, e = graph.nodes["mesh"], graph.nodes["grid"], graph.edges["grid2mesh"]
    xyz_m, xyz_g = gm.to_xyz(mesh.lat, mesh.lon), gm.to_xyz(grid.lat, grid.lon)
    radius = FRACTION * ico.longest_side(ico.hierarchy(max(LEVELS))[-1])
    want = {(g, m) for g in range(grid.n) for m in range(mesh.n)
            if np.linalg.norm(xyz_g[g] - xyz_m[m]) <= radius}
    got = set(zip(e.senders[e.real].tolist(), e.receivers[e.real].tolist()))
    assert got == want and len(got) == e.n


@pytest.mark.parametrize("name", ["grid2mesh", "mesh", "mesh2grid"])
def test_layouts_for_the_segment_sum(graph, name):
    """Each edge set's receivers are consecutive in its layout (one run a
    receiver, as #3 needs), its padding slots masked with zero features and
    sending from the sender set's last padding node; its sender view in run
    order holds every slot once, each under its sender, runs consecutive."""
    e = graph.edges[name].to("cpu")
    n_r = graph.nodes[e.receiver_set].n_padded
    n_s = graph.nodes[e.sender_set].n_padded
    assert runs_are_consecutive(e.receivers, n_r)
    assert not e.features[~e.real].any() and (e.senders[~e.real] == n_s - 1).all()
    assert torch.equal(e.mask[:, 0], e.real.float())
    perm, sorted_senders, _ = e.view
    kept = sorted_senders >= 0
    assert torch.equal(torch.sort(perm[kept]).values, torch.arange(e.slots, dtype=torch.int32))
    assert torch.equal(e.senders[perm[kept].long()], sorted_senders[kept])
    assert runs_are_consecutive(sorted_senders, n_s)


@pytest.mark.parametrize("res,levels", [(10.0, [1, 2]), (5.0, [0, 1, 2, 3])])
def test_two_builders_agree(res, levels):
    """The port's builder and the reference's, written apart, give the same
    edges (by their endpoints' positions) with the same features to fp32
    rounding, the tied mesh2grid nodes too."""
    g = gm.grid_mesh_graph(res, levels, FRACTION)
    r = ref.build_graph(res, levels, FRACTION)
    assert g.counts() == r.counts()
    v0, faces = ref._icosahedron()
    verts, by_level = list(v0), [faces]
    for _ in range(max(levels)):
        by_level.append(ref._split(verts, by_level[-1]))
    r_lat, r_lon = (t.numpy() for t in ref._lat_lon(torch.stack(verts)))
    port = {k: (v.lat, v.lon) for k, v in g.nodes.items()}
    mine = {"grid": port["grid"], "mesh": (r_lat, r_lon)}
    for name, e in g.edges.items():
        def keys(pos, s, t):
            (a, b), (c, d) = pos[e.sender_set], pos[e.receiver_set]
            return np.round(np.stack([a[s], b[s], c[t], d[t]], 1), 6)
        got = keys(port, e.senders[e.real], e.receivers[e.real])
        snd, rcv, feats = r.edges[name]
        want = keys(mine, snd.numpy(), rcv.numpy())
        i, j = np.lexsort(got.T[::-1]), np.lexsort(want.T[::-1])
        assert np.array_equal(got[i], want[j]), name
        np.testing.assert_allclose(e.features[e.real][i], feats.numpy()[j], rtol=0, atol=1e-7)


# --- the model against the reference


def port_model(inputs, params: dict) -> gc.GraphCast:
    model = gc.GraphCast(latent_size=L, message_passing_steps=STEPS,
                         stats=gc.compute_graphcast_stats(arch.port_samples(inputs)))
    model.load_state_dict({k: v.clone() for k, v in params.items()})
    return model


def reference_readings(inputs, params: dict, dtype: torch.dtype) -> dict:
    """The reference's loss, gradients (clipped, as the update takes them)
    and one AdamW step with clipping on sample 0, computed in ``dtype``."""
    p = {k: v.detach().to(dtype).requires_grad_(True) for k, v in params.items()}
    batch = arch.reference_batch(inputs, [0], "cpu")
    loss = ref.loss(p, batch, arch.reference_stats(inputs), STEPS, 1)
    grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    stepped = {k: v.detach().clone() for k, v in p.items()}
    clipped = ref.adamw_clip_update(stepped, grads, {}, LR, BETAS, DECAY, 1.0)
    return {"loss": float(loss.detach()), "grad": {k: g.double() for k, g in clipped.items()},
            "step": {k: (stepped[k] - p[k].detach()).double() for k in p}}


def port_readings(inputs, params: dict) -> dict:
    """The port's loss, gradients (clipped in place by the step) and one
    AdamW step with clipping through ``Trainer`` on sample 0."""
    model = port_model(inputs, params)
    trainer = Trainer(model=model, learning_rate=LR, objective=gc.objective, device="cpu",
                      betas=BETAS, weight_decay=DECAY, clip_norm=1.0)
    aux = trainer.train_step(arch.port_samples(inputs)[0])
    return {"loss": float(aux["total"]),
            "grad": {k: p.grad.double() for k, p in model.named_parameters()},
            "step": {k: (p.detach() - params[k]).double() for k, p in model.named_parameters()}}


def gaps(got: dict, want: dict) -> dict[str, float]:
    out = {"loss": abs(got["loss"] - want["loss"]) / abs(want["loss"]),
           "gradient": max(float((got["grad"][k] - g).norm() / g.norm())
                           for k, g in want["grad"].items() if g.norm() > 0)}
    adamw = 0.0
    for k, g in want["grad"].items():
        kept = g.abs() > 1e-3 * g.abs().max()
        if kept.any():
            adamw = max(adamw, float((got["step"][k] - want["step"][k]).abs()[kept].max()) / LR)
    out["adamw"] = adamw
    return out


@pytest.fixture(scope="module")
def readings(inputs):
    params = arch.draw_weights(CFG, SEED, "cpu")
    return {"port": port_readings(inputs, params),
            "fp64": reference_readings(inputs, params, torch.float64),
            "bf16": reference_readings(inputs, params, torch.bfloat16),
            "params": params}


@pytest.mark.parametrize("reading", sorted(TOL))
def test_matches_the_plain_reference(readings, reading):
    """Loss, every parameter's gradient and one AdamW step (clipped to a
    global norm of 1, which these gradients pass, so the clip acts) against
    the fp64 reference."""
    gap = gaps(readings["port"], readings["fp64"])
    assert gap[reading] <= TOL[reading], (reading, gap)
    norm = sum(float((g ** 2).sum()) for g in readings["fp64"]["grad"].values()) ** 0.5
    assert norm == pytest.approx(1.0)  # clipped from above


def test_bf16_reference_fails_a_tolerance(readings):
    """The tolerances are tight enough to catch a lower precision."""
    gap = gaps(readings["bf16"], readings["fp64"])
    assert any(gap[k] > TOL[k] for k in TOL), gap


def test_every_parameter_named_as_the_reference_reads_it(readings):
    """The weights' names and shapes are the architecture module's spec, the
    decoder's mesh-node MLP left out; the mesh embedder's zero input columns
    take no gradient."""
    spec = {name: shape for name, shape, _ in arch.parameter_spec(CFG)}
    assert {k: tuple(v.shape) for k, v in readings["params"].items()} == spec
    grad = readings["port"]["grad"]["mesh_embed.lin0.kernel"]
    assert not grad[:gc.INPUTS].any() and grad[gc.INPUTS:].any()


def test_padding_rows_add_nothing(inputs):
    """Changing a sample's padding rows and the padding nodes' features
    leaves the loss and every gradient as they were, bit for bit."""
    params = arch.draw_weights(CFG, SEED, "cpu")

    def loss_and_grads(sample):
        model = port_model(inputs, params)
        loss = gc.graphcast_loss(sample, model(sample), model)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        return loss, grads

    sample = arch.port_samples(inputs)[0].to("cpu")
    n = sample.graph.nodes["grid"].n
    noisy_in, noisy_out = sample.inputs.clone(), sample.targets.clone()
    noisy_in[n:], noisy_out[n:] = 7.0, -3.0
    other = TypedSample(sample.graph, noisy_in, noisy_out, sample.graph_node_count)
    (a, ga), (b, gb) = loss_and_grads(sample), loss_and_grads(other)
    assert torch.equal(a, b) and all(torch.equal(x, y) for x, y in zip(ga, gb))


def test_channel_and_latitude_weights():
    """w_v · w_ℓ / 13 over the atmospheric levels, 0.1 on the four
    down-weighted surface channels; latitude weights of mean 1 over the
    rows, the poles' caps the smallest."""
    w = gc.channel_weights()
    assert w.shape == (gc.TARGETS,)
    assert list(w[:5]) == [1.0, 0.1, 0.1, 0.1, 0.1]
    np.testing.assert_allclose(w[5:].reshape(6, 13).sum(1), 1.0)
    lat, _ = gm.lat_lon_grid(1.0)
    a = gc.latitude_weights(lat)
    np.testing.assert_allclose(a.mean(), 1.0)
    assert a.argmin() in (0, len(lat) - 1) and a[0] == a[-1] < 0.01
    np.testing.assert_allclose(a, ref.latitude_weights(torch.as_tensor(lat)).numpy())


# --- the shared edge update


def bipartite_problem(graph, name: str, width: int, seed: int = 3) -> tuple:
    e = graph.edges[name].to("cpu")
    n_s = graph.nodes[e.sender_set].n_padded
    n_r = graph.nodes[e.receiver_set].n_padded
    rng = np.random.default_rng(seed)
    f32 = lambda *s, scale=1.0: torch.as_tensor(  # noqa: E731
        (rng.normal(size=s) * scale).astype(np.float32))
    w = lambda: f32(width, width, scale=width**-0.5)  # noqa: E731
    floats = (f32(n_s, width), f32(n_r, width), f32(e.slots, width), w(), f32(width), w(),
              f32(width), 1 + f32(width, scale=0.1), f32(width, scale=0.1))
    return e, [t.requires_grad_(True) for t in floats]


@pytest.mark.parametrize("activation", ["silu", "relu"])
@pytest.mark.parametrize("name", ["grid2mesh", "mesh2grid"])
def test_edge_update_two_node_sets(graph, name, activation):
    """``mgn_edge.plain_edge_update`` between two node sets of their own
    sizes (the plain forward, the function's own backward with #3's sums
    sized by each set) against autograd through the plain composition: the
    forward bit-equal, every gradient to 1e-6 of its norm."""
    e, floats = bipartite_problem(graph, name, L)
    p_s, p_r, x, w_e, b0, w1, b1, gamma, beta = floats
    got = mgn_edge.plain_edge_update(p_s, p_r, x, w_e, b0, (w1, b1), gamma, beta, e.mask,
                                     e.senders, e.receivers, e.block_tile, e.view, e.tile,
                                     activation=activation)
    act = mgn_edge.ACTIVATIONS[activation]
    pre = (sender_gather_one(p_s, e.senders, e.view, e.tile)
           + p_r.index_select(0, e.receivers) + x @ w_e + b0)
    y = act(pre) @ w1 + b1
    new = torch.nn.functional.layer_norm(y, (L,), gamma, beta, mgn_edge.LN_EPS) * e.mask
    want = (new, x + new)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    rng = np.random.default_rng(5)
    cots = [torch.as_tensor(rng.normal(size=t.shape).astype(np.float32)) for t in got]
    g_got = torch.autograd.grad(got, floats, cots)
    g_want = torch.autograd.grad(want, floats, cots)
    for i, (a, b) in enumerate(zip(g_got, g_want)):
        assert float(b.norm()) > 0, i
        assert float((a - b).norm()) <= 1e-6 * float(b.norm()), i


class LaunchStub:
    """The card's route taken on CPU tensors: ``device_kind`` says "cuda", a
    launch counts and raises (none is expected here)."""

    def __init__(self, monkeypatch):
        real = mgn_edge.cuda_build
        self.launches = 0

        def launch(*args):
            self.launches += 1
            raise AssertionError("the kernel was launched")

        stub = type("CudaBuild", (), {
            "device_kind": staticmethod(lambda who, *tensors: "cuda"),
            "library": real.library, "launch": staticmethod(launch),
            "launches": real.launches})
        monkeypatch.setattr(mgn_edge, "cuda_build", stub)


@pytest.mark.parametrize("case", ["silu", "two_sets", "graphcast_width"])
def test_plain_route_on_the_card(graph, monkeypatch, case):
    """On CUDA-like tensors ``plain_edge_update`` runs the plain composition
    where the kernel was not built for the MLP (SiLU; two node sets of their
    own sizes; L = 512 with one hidden layer, GraphCast's): it launches
    nothing and counts no fused rows. ``edge_update``, the kernel's route,
    raises on each of these; MeshGraphNets' case (L = 128, two hidden
    layers, ReLU, one node set) still takes the kernel
    (``test_torch_port_meshgraphnets.py``, through its stub launch)."""
    stub = LaunchStub(monkeypatch)
    W = {"silu": 128, "two_sets": 128, "graphcast_width": 512}[case]
    e, floats = bipartite_problem(graph, "mesh" if case == "silu" else "grid2mesh", W)
    p_s, p_r, x, w_e, b0, w1, b1, gamma, beta = floats
    layers = (w1, b1) if case == "graphcast_width" else (w1, b1, w1, b1)
    act = "silu" if case != "two_sets" else "relu"
    args = (p_s, p_r, x, w_e, b0, layers, gamma, beta, e.mask, e.senders, e.receivers,
            e.block_tile, e.view, e.tile)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.no_grad():
            out = mgn_edge.plain_edge_update(*args, activation=act)
            with pytest.raises(ValueError, match="mgn_edge_update"):
                mgn_edge.edge_update(*args, activation=act)
    assert stub.launches == 0 and "mgn.edge_fused_rows" not in profiling.recorded().counters
    plain = mgn_edge.edge_update_reference(p_s, p_r, x, w_e, b0, layers, gamma, beta, e.mask,
                                           e.senders, e.receivers, act)
    assert torch.equal(out[0], plain[0])


@pytest.mark.parametrize("entry", ["edge_update", "plain_edge_update"])
def test_unknown_activation_raises(graph, entry):
    e, floats = bipartite_problem(graph, "mesh", L)
    p_s, p_r, x, w_e, b0, w1, b1, gamma, beta = floats
    with pytest.raises(ValueError, match="activation"):
        getattr(mgn_edge, entry)(p_s, p_r, x, w_e, b0, (w1, b1), gamma, beta, e.mask, e.senders,
                                 e.receivers, e.block_tile, e.view, e.tile, activation="tanh")


# --- the trainer and the loader


def tiny_trainer(seed: int = 0, **kwargs) -> Trainer:
    gen = torch.Generator().manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(5, 7), torch.nn.Tanh(), torch.nn.Linear(7, 3))
    for p in model.parameters():
        with torch.no_grad():
            p.copy_(torch.randn(p.shape, generator=gen))

    def objective(trainer, batch, training):
        total = ((trainer.model(batch.x) - batch.y) ** 2).mean()
        return total, {"mse": total}

    return Trainer(model=model, objective=objective, device="cpu", **kwargs)


class Toy:
    def __init__(self, seed: int):
        g = torch.Generator().manual_seed(seed)
        self.x, self.y = torch.randn(11, 5, generator=g), torch.randn(11, 3, generator=g) * 30

    def to(self, device, non_blocking=False):
        return self


def test_default_trainer_is_adam_bit_for_bit():
    """With its defaults the trainer runs torch's Adam as before (betas 0.9,
    0.999, eps 1e-8, no decay, no clipping): three steps bit-equal to a
    hand-built ``torch.optim.Adam``."""
    trainer = tiny_trainer()
    twin = tiny_trainer()
    assert trainer.init().param_groups[0]["weight_decay"] == 0.0
    opt = torch.optim.Adam(twin.model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    for k in range(3):
        trainer.train_step(Toy(k))
        twin.model.zero_grad()
        twin.objective(twin, Toy(k), True)[0].backward()
        opt.step()
    for a, b in zip(trainer.model.parameters(), twin.model.parameters()):
        assert torch.equal(a, b)


def test_adamw_with_clipping_matches_the_reference():
    """Betas (0.9, 0.95), decoupled decay 0.1 and clipping to a global norm
    of 1 (the toy's gradients are far larger): three steps against the
    reference's ``adamw_clip_update`` in fp64, to fp32 rounding."""
    trainer = tiny_trainer(betas=BETAS, weight_decay=DECAY, clip_norm=1.0)
    params = {k: v.detach().double().clone() for k, v in trainer.model.named_parameters()}
    state: dict = {}
    for k in range(3):
        leaves = {n: v.clone().requires_grad_(True) for n, v in params.items()}
        batch = Toy(k)
        h = torch.tanh(batch.x.double() @ leaves["0.weight"].T + leaves["0.bias"])
        loss = ((h @ leaves["2.weight"].T + leaves["2.bias"] - batch.y.double()) ** 2).mean()
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        assert sum(float((g ** 2).sum()) for g in grads.values()) > 100.0
        ref.adamw_clip_update(params, grads, state, 1e-3, BETAS, DECAY, 1.0)
        trainer.train_step(batch)
    assert isinstance(trainer.optimizer, torch.optim.AdamW)
    for name, p in trainer.model.named_parameters():
        np.testing.assert_allclose(p.detach().double(), params[name], rtol=0, atol=1e-6)


def test_clipping_leaves_small_gradients_alone():
    """A global norm under the limit leaves the gradients as they were, bit
    for bit (the scale is exactly 1)."""
    trainer = tiny_trainer(clip_norm=1e9)
    grads = trainer.loss_and_grads(Toy(0))[1]
    before = {k: g.clone() for k, g in grads.items()}
    from p_div_gnn_tpu_torch.train.loop import clip_by_global_norm

    clip_by_global_norm(trainer.model.parameters(), 1e9)
    assert all(torch.equal(g, before[k]) for k, g in grads.items())


def test_fixed_graph_loader(inputs):
    """The samples go to the device once, share one graph there, and come
    out one a step in the order the benchmark's reference follows
    (``harness/train.py::first_groups``), a new order each epoch."""
    samples = arch.port_samples(inputs)
    loader = FixedGraphLoader(samples, seed=69, device="cpu")
    assert len({id(s.graph) for s in loader.samples}) == 1 and loader.samples[0].graph.is_on("cpu")
    firsts = [[id(b) for b in prefetch(loader, "cpu")] for _ in range(2)]
    index = {id(s): i for i, s in enumerate(loader.samples)}
    epoch0 = [index[i] for i in firsts[0]]
    assert sorted(epoch0) == list(range(len(samples)))
    assert epoch0 == [int(g[0]) for g in train.first_groups(len(samples), 1, 69, len(samples))]
    assert [index[i] for i in firsts[1]] != epoch0
    with pytest.raises(ValueError, match="share one graph"):
        FixedGraphLoader(samples[:1] + arch.port_samples(
            {**inputs, "graph": gm.grid_mesh_graph(RES, LEVELS, FRACTION)})[:1], device="cpu")


# --- spans, counters, one device


def test_spans_and_counters(inputs):
    """A forward records ``graphcast.grid2mesh``, one ``graphcast.edge`` and
    one ``graphcast.node`` a processor step (``block`` 0 .. S-1) and
    ``graphcast.mesh2grid``; the counters add every edge update's slots and
    real edges; no fused rows."""
    model = port_model(inputs, arch.draw_weights(CFG, SEED, "cpu"))
    sample = arch.port_samples(inputs)[0].to("cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.no_grad():
            model(sample)
    rec = profiling.recorded()
    for name in ("graphcast.grid2mesh", "graphcast.mesh2grid"):
        assert len(rec.named(name)) == 1
    for name in ("graphcast.edge", "graphcast.node"):
        assert [s.attrs["block"] for s in rec.named(name)] == list(range(STEPS))
    e = sample.graph.edges
    sets = (e["grid2mesh"], *[e["mesh"]] * STEPS, e["mesh2grid"])
    assert rec.counters["graphcast.edge_rows"] == sum(x.slots for x in sets)
    assert rec.counters["graphcast.edge_real_rows"] == sum(x.n for x in sets)
    assert "mgn.edge_fused_rows" not in rec.counters


def test_one_device_only(inputs):
    model = port_model(inputs, arch.draw_weights(CFG, SEED, "cpu"))
    sample = arch.port_samples(inputs)[0].to("cpu")
    with pytest.raises(ValueError, match="halo"):
        model(sample, halo=object())
    trainer = Trainer(model=model, objective=gc.objective, device="cpu", group=object())
    with pytest.raises(ValueError, match="one device"):
        trainer.train_step(sample)


# --- the benchmark's cell at a tiny size


def tiny_cell() -> tuple[dict, dict]:
    work = registry.cell("train.graphcast.fp32")
    cfg, traffic = registry.config(work), registry.traffic(work["traffic"])
    cfg.update(latent_size=L, message_passing_steps=STEPS, resolution=RES, mesh_levels=LEVELS)
    traffic.update(samples=4, warmup_steps=1, trace_steps=2)
    return cfg, traffic


@pytest.mark.parametrize("fault", (None,) + FAULTS)
def test_benchmark_cell_judges_the_program(fault):
    """The benchmark's tiny loop reads the sound program correct and each
    planted fault not."""
    cfg, traffic = tiny_cell()
    with planted(fault, cfg["arch"]) if fault else contextlib.nullcontext():
        out = train_grid.run(cfg, traffic, SEED, 0.3, False, "cpu", time.perf_counter(),
                             workers=1)
    correct, checks = judged(out["numbers"], limits("train.graphcast.fp32"))
    assert correct == (fault is None), checks
    assert out["attempted"] > 0 and out["failed"] == 0 and out["train_edges_per_s"] > 0


def test_benchmark_kind_runs_its_own_program_and_reference(monkeypatch):
    """``train_grid.run`` drives ``harness/train.py``'s loop with this kind's
    pieces: every batch its ``Program`` sees is a ``TypedSample``, the
    reference is its GraphCast reference, and ``harness/train.py``'s own
    inputs, ``Program`` and reference are back in place afterwards."""
    names = ("make_inputs", "Program", "reference_first_steps")
    before = {name: getattr(train, name) for name in names}
    seen, refs = [], []
    shape, first_steps = train_grid.Program.shape, train_grid.reference_first_steps

    def spy_shape(self, batch):
        seen.append(type(batch))
        return shape(self, batch)

    def spy_steps(cfg, *args, **kwargs):
        refs.append(cfg["arch"])
        return first_steps(cfg, *args, **kwargs)

    monkeypatch.setattr(train_grid.Program, "shape", spy_shape)
    monkeypatch.setattr(train_grid, "reference_first_steps", spy_steps)
    cfg, traffic = tiny_cell()
    train_grid.run(cfg, traffic, SEED, 0.1, False, "cpu", time.perf_counter(), workers=1)
    assert seen and set(seen) == {TypedSample}
    assert refs == ["graphcast"]
    assert {name: getattr(train, name) for name in names} == before


def test_benchmark_reads_the_edge_padding_share(monkeypatch):
    """``graphcast.edge_padding_share`` over a traced window of the tiny
    cell: the edge updates' slots against their real edges, as counted by
    hand from the layouts; a step's E and N are the graph's real edges and
    nodes; None where the program counts no rows."""
    cfg, traffic = tiny_cell()
    out = train_grid.run(cfg, traffic, SEED, 0.3, True, "cpu", time.perf_counter(), workers=1)
    run = Run(cfg=cfg, unit=train_grid.UNIT, units=out["units"], trace=out["trace"], kernels={})
    g = gm.grid_mesh_graph(RES, LEVELS, FRACTION)
    sets = (g.edges["grid2mesh"], *[g.edges["mesh"]] * STEPS, g.edges["mesh2grid"])
    slots, real = sum(e.slots for e in sets), sum(e.n for e in sets)
    reader = registry.metric_reader("graphcast.edge_padding_share")
    assert reader.read(run) == pytest.approx(100 * (1 - real / slots))
    assert out["units"][0]["E"] == sum(e.n for e in g.edges.values())
    assert out["units"][0]["N"] == sum(n.n for n in g.nodes.values())
    rec = profiling.recorded()
    rec.counters.pop("graphcast.edge_rows")
    monkeypatch.setattr(profiling, "recorded", lambda: rec)
    assert reader.read(run) is None


SPAN_READERS = {"graphcast.grid2mesh_ms": "graphcast.grid2mesh",
                "graphcast.processor_edge_ms": "graphcast.edge",
                "graphcast.processor_node_ms": "graphcast.node",
                "graphcast.mesh2grid_ms": "graphcast.mesh2grid"}


def span_record(with_spans: bool) -> profiling.Recording:
    """Two steps, each with its encoder, two processor steps and decoder at
    hand-set device ms (step k's processor edge spans 3 + k and 4 + k ms)."""
    spans = []

    def add(name, device_ms=None, **attrs):
        spans.append(profiling.Span(name, 0, 1, 1, len(spans), None, attrs, device_ms=device_ms))

    for k in range(2):
        add("step", step=k)
        if with_spans:
            add("graphcast.grid2mesh", 10.0 + k)
            for b in range(2):
                add("graphcast.edge", 3.0 + b + k, block=b)
                add("graphcast.node", 1.0 + b, block=b)
            add("graphcast.mesh2grid", 20.0)
    return profiling.Recording(spans=spans, counters={}, base_ns=0)


@pytest.mark.parametrize("name", sorted(SPAN_READERS))
def test_span_readers_hand_count(name, monkeypatch):
    """Each span reader: its spans' device ms summed over the window, a
    step; None where the program recorded no such span, or no step."""
    from perfbench.harness.trace import Trace

    run = Run(cfg=CFG, unit="step", units=[{"E": 1, "N": 1}] * 2,
              trace=Trace(device=[], host=[], start_us=0.0, end_us=1.0), kernels={})
    want = {"graphcast.grid2mesh_ms": (10 + 11) / 2, "graphcast.processor_edge_ms": (7 + 9) / 2,
            "graphcast.processor_node_ms": 3.0, "graphcast.mesh2grid_ms": 20.0}
    reader = registry.metric_reader(name)
    monkeypatch.setattr(profiling, "recorded", lambda: span_record(True))
    assert reader.read(run) == pytest.approx(want[name])
    monkeypatch.setattr(profiling, "recorded", lambda: span_record(False))
    assert reader.read(run) is None
    monkeypatch.setattr(profiling, "recorded", profiling.Recording)
    assert reader.read(run) is None


STEP_READERS = {"step.forward_ms": (5.0 + 6.0) / 2, "step.backward_ms": 9.0,
                "step.optimizer_ms": 1.0, "step.host_code_idle_ms": 1e-3 / 2,
                "loader.wait_ms": 3e-3, "step.host_syncs": 0.0}


@pytest.mark.parametrize("name", sorted(STEP_READERS))
def test_step_readers_for_the_cell(name, monkeypatch):
    """The training step's readers under the cell's names read what the
    ``.train`` readers read: a hand count over two steps (device ms of the
    phases, host ms of the loader's waits, the host-code idle of a 1 µs
    window with no kernel inside a step span, no host sync), and None where
    the program recorded no step."""
    from perfbench.harness.trace import Trace

    spans = []

    def add(name, device_ms=None, end_ns=2000):
        spans.append(profiling.Span(name, 0, end_ns, 1, len(spans), None, {},
                                    device_ms=device_ms))

    for k in range(2):
        add("loader.wait", end_ns=3000)
        add("step")
        add("step.forward", 5.0 + k)
        add("step.backward", 9.0)
        add("step.optimizer", 1.0)
    run = Run(cfg=CFG, unit="step", units=[{"E": 1, "N": 1}] * 2,
              trace=Trace(device=[], host=[], start_us=0.0, end_us=1.0), kernels={})
    ours, theirs = (registry.metric_reader(f"{name}.{cell}") for cell in ("graphcast", "train"))
    monkeypatch.setattr(profiling, "recorded",
                        lambda: profiling.Recording(spans=spans, counters={}, base_ns=0))
    assert ours.read(run) == theirs.read(run) == pytest.approx(STEP_READERS[name])
    monkeypatch.setattr(profiling, "recorded", profiling.Recording)
    assert ours.read(run) is None


def test_model_flops_least_form():
    """``model_flops`` at the configuration's built graph: a processor
    step's edge stream 4·L² a multimesh edge (85.6 GFLOP), the whole
    forward about 2.7 TFLOP, the concat form's edge MLPs 1.5x the least
    form's."""
    cfg = registry.config(registry.cell("train.graphcast.fp32"))
    g = cfg["graph"]
    E = g["grid2mesh_edges"] + g["mesh_edges"] + g["mesh2grid_edges"]
    stream, other = arch.model_flops(cfg, E, g["grid_nodes"] + g["mesh_nodes"])
    L2 = cfg["latent_size"] ** 2
    assert stream == pytest.approx(4 * L2 * (E + (cfg["message_passing_steps"] - 1)
                                             * g["mesh_edges"]))
    assert 2.6e12 < stream + other < 2.8e12
    assert 4 * L2 * g["mesh_edges"] == pytest.approx(85.6e9, rel=1e-3)
