"""MeshGraphNets on the port's training path (``models/meshgraphnets.py``)
against the plain reference that the benchmark holds it to
(``perfbench/reference/meshgraphnets.py``, plain torch in fp64), on seeded
random weights at a small size (L = 16, 3 blocks, 3 toy meshes): the
output, the loss, every parameter's gradient and one Adam step through
``Trainer``; the same reference in bfloat16 fails one of those
tolerances; other MLP depths against the same reference. Also: the
receiver rows' gradient against torch's indexing, the per-node fields
through packing and unpacking, the blocks' own weights, the ``mgn.*``
spans, the edge stream on the batch's live slots (the same result bit for
bit whatever the spare edge capacity, the rows the edge MLPs see, the one
sync), the fused edge update
(``ops/mgn_edge.py``: its plain forward and its own backward against
autograd through the composition it replaced, its kernel route's checks
and counter through a stub of the launch), and the benchmark's cell at a
tiny size with its faults and the readers of its edge metrics."""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import pytest
import torch

from p_div_gnn_tpu_torch.graphs.batching import (
    GraphSample,
    NodeFieldSample,
    pack_batch,
    unpack_predictions,
)
from p_div_gnn_tpu_torch.graphs.build import MeshGraph
from p_div_gnn_tpu_torch.graphs.container import EDGE_BLOCK
from p_div_gnn_tpu_torch.models import meshgraphnets as mgn
from p_div_gnn_tpu_torch.ops import mgn_edge
from p_div_gnn_tpu_torch.ops.gather import sender_gather_one
from p_div_gnn_tpu_torch.ops.scatter_csr import csr_segment_sum
from p_div_gnn_tpu_torch.train.loop import Trainer
from p_div_gnn_tpu_torch.utils import profiling
from perfbench.arch import mgn as arch
from perfbench.harness import registry, train
from perfbench.harness.compare import judged, limits
from perfbench.harness.faults import FAULTS, planted
from perfbench.harness.yardstick import Run
from perfbench.inputs.graph import edge_distances, faces_to_edge_index
from perfbench.reference import meshgraphnets as ref
from perfbench.reference.model import adam_update
from toy_meshes import grid_mesh_with_hole

L, BLOCKS, LR = 16, 3, 1e-3
CFG = {"latent_size": L, "message_passing_steps": BLOCKS, "hidden_layers": 2,
       "node_inputs": mgn.NODE_FEATURES, "edge_inputs": mgn.EDGE_FEATURES,
       "outputs": mgn.OUT_FEATURES}
# Tolerances of the fp32 program against the fp64 reference, each a
# relative error (fp32's unit round-off is 6e-8, bfloat16's 3.9e-3):
# - output: largest entry gap over the largest entry; ~40 fp32 sums and
#   products in a row (encoders, 3 blocks of two MLPs, decoder) with
#   LayerNorms between them read 2-3e-7, so 1e-5 is 30x room;
# - loss: the mean of squares of those outputs, read ~4e-8; 1e-6;
# - gradient: each parameter's gap norm over its reference norm, read
#   under 1e-6 (the backward runs the chains again, and the sums over
#   edges and nodes add their round-off); 1e-4;
# - Adam step: on the entries whose reference gradient is over 1e-3 of the
#   leaf's largest, the step's gap over the learning rate. A first Adam
#   step moves an entry by lr·g/(|g| + eps), which depends on the gradient
#   only through its sign where |g| >> eps; what is left is the rounding
#   of the stepped parameter to fp32, half an ulp of it: 6e-8 of the
#   LayerNorm scales' 1, 6e-5 of lr, read 5.8e-5; 1e-3. An entry whose
#   gradient is nought to rounding may move either way on either side,
#   and is held only to Adam's bound of lr (2 lr apart).
TOL = {"output": 1e-5, "loss": 1e-6, "gradient": 1e-4, "adam": 1e-3}
# the types the toy meshes' nodes take, NORMAL and OUTFLOW among them
TYPES = (mgn.NORMAL, mgn.OBSTACLE, mgn.INFLOW, mgn.OUTFLOW, mgn.WALL_BOUNDARY)


def toy_sample(seed: int, nx: int) -> NodeFieldSample:
    mesh = grid_mesh_with_hole(nx, nx, 10.0, (2, 2))
    n = len(mesh.points)
    rng = np.random.default_rng(seed)
    ei = faces_to_edge_index(mesh.faces, n)
    pos = mesh.points[:, :2].astype(np.float32)
    types = rng.choice(TYPES, size=n, p=(0.6, 0.1, 0.1, 0.1, 0.1))
    inputs = np.concatenate([rng.normal(size=(n, 2)), np.eye(mgn.NODE_TYPES)[types]], axis=1)
    graph = MeshGraph(pos=pos, edge_index=ei, edge_weight=edge_distances(pos, ei),
                      faces=mesh.faces)
    return NodeFieldSample(
        graph=graph, mean_stress=np.zeros(3, np.float32), local_stress=np.zeros((n, 3), np.float32),
        node_labels=np.zeros(n, np.int64), div_data=np.zeros(0, np.float32),
        div_row=np.zeros(0, np.int64), div_col=np.zeros(0, np.int64),
        node_inputs=inputs.astype(np.float32),
        node_targets=rng.normal(size=(n, 2)).astype(np.float32))


@pytest.fixture(scope="module")
def samples() -> list[NodeFieldSample]:
    return [toy_sample(seed, nx) for seed, nx in ((0, 6), (1, 7), (2, 5))]


def make_model(samples, seed: int = 0, hidden_layers: int = 2) -> mgn.MeshGraphNets:
    return mgn.MeshGraphNets(latent_size=L, message_passing_steps=BLOCKS,
                             hidden_layers=hidden_layers, stats=mgn.compute_mgn_stats(samples),
                             generator=torch.Generator().manual_seed(seed))


def packed(samples, reorder: str | None = "rcm"):
    return pack_batch(samples, n_graphs=len(samples) + 1, reorder=reorder).to("cpu")


def ref_batch(samples) -> ref.MGNBatch:
    """The samples concatenated in their own node order."""
    offsets = np.cumsum([0] + [s.num_nodes for s in samples])
    cat = lambda parts: torch.as_tensor(np.concatenate(parts))  # noqa: E731
    return ref.MGNBatch(
        node_inputs=cat([s.node_inputs for s in samples]).double(),
        pos=cat([s.graph.pos[:, :2] for s in samples]).double(),
        senders=cat([s.graph.edge_index[0] + o for s, o in zip(samples, offsets)]).long(),
        receivers=cat([s.graph.edge_index[1] + o for s, o in zip(samples, offsets)]).long(),
        targets=cat([s.node_targets for s in samples]).double())


def ref_stats(samples) -> dict:
    return ref.normalisers(
        [torch.as_tensor(s.node_inputs) for s in samples],
        [ref.edge_inputs(torch.as_tensor(s.graph.pos[:, :2]).double(),
                         *torch.as_tensor(s.graph.edge_index)) for s in samples],
        [torch.as_tensor(s.node_targets) for s in samples])


def reference_readings(samples, params: dict, dtype: torch.dtype,
                       hidden_layers: int = 2) -> dict:
    """The reference's output (in the meshes' order), loss, gradients and
    one Adam step, computed in ``dtype``."""
    p = {k: v.detach().to(dtype).requires_grad_(True) for k, v in params.items()}
    batch, stats = ref_batch(samples), ref_stats(samples)
    out = ref.forward(p, batch, stats, BLOCKS, hidden_layers)
    loss = ref.loss(p, batch, stats, BLOCKS, hidden_layers)
    grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    stepped = {k: v.detach().clone() for k, v in p.items()}
    adam_update(stepped, grads, {}, LR)
    return {"output": out.detach().double(), "loss": float(loss.detach()),
            "grad": {k: g.double() for k, g in grads.items()},
            "step": {k: (stepped[k] - p[k].detach()).double() for k in p}}


def port_readings(samples, model: mgn.MeshGraphNets) -> dict:
    """The port's output (in the meshes' order), loss, gradients and one
    Adam step through ``Trainer`` with MeshGraphNets' objective."""
    batch = packed(samples)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    with torch.no_grad():
        out = np.concatenate(unpack_predictions(batch, model(batch)))
    trainer = Trainer(model=model, learning_rate=LR, objective=mgn.objective, device="cpu")
    aux = trainer.train_step(batch)  # leaves each parameter's .grad set
    grads = {k: p.grad.double() for k, p in model.named_parameters()}
    return {"output": torch.as_tensor(out).double(), "loss": float(aux["total"]),
            "grad": grads,
            "step": {k: (p.detach() - before[k]).double() for k, p in model.named_parameters()}}


def gaps(got: dict, want: dict) -> dict[str, float]:
    """Each compared reading's relative gap (the tolerances' comment)."""
    out = {"output": float((got["output"] - want["output"]).abs().max()
                           / want["output"].abs().max()),
           "loss": abs(got["loss"] - want["loss"]) / abs(want["loss"]),
           "gradient": max(float((got["grad"][k] - g).norm() / g.norm())
                           for k, g in want["grad"].items() if g.norm() > 0)}
    adam = bound = 0.0
    for k, g in want["grad"].items():
        kept = g.abs() > 1e-3 * g.abs().max()
        diff = (got["step"][k] - want["step"][k]).abs()
        bound = max(bound, float(diff.max()) / LR)
        if kept.any():
            adam = max(adam, float(diff[kept].max()) / LR)
    out["adam"] = adam
    out["adam_bound"] = bound  # every entry's step gap over the learning rate
    return out


@pytest.fixture(scope="module")
def readings(samples):
    model = make_model(samples)
    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    return {"port": port_readings(samples, model),
            "fp64": reference_readings(samples, params, torch.float64),
            "bf16": reference_readings(samples, params, torch.bfloat16)}


@pytest.mark.parametrize("reading", sorted(TOL))
def test_matches_the_plain_reference(readings, reading):
    gap = gaps(readings["port"], readings["fp64"])
    assert gap[reading] <= TOL[reading], (reading, gap)
    assert gap["adam_bound"] <= 2 * (1 + 1e-6)  # each entry moves by lr at most on each side


def test_bf16_reference_fails_a_tolerance(readings):
    """The tolerances are tight enough to catch a lower precision."""
    gap = gaps(readings["bf16"], readings["fp64"])
    assert any(gap[k] > TOL[k] for k in TOL), gap
    assert gap["output"] > 100 * TOL["output"], gap


@pytest.mark.parametrize("hidden_layers", [1, 3])
def test_other_mlp_depths_match_the_plain_reference(samples, hidden_layers):
    """A depth other than the published 2 hidden layers runs on the CPU's
    plain path (the card's kernel refuses it), held to the same fp64
    reference and tolerances: output, loss, gradients and one Adam step."""
    model = make_model(samples, hidden_layers=hidden_layers)
    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    assert f"blocks.0.edge_mlp.lin{hidden_layers}.kernel" in params
    gap = gaps(port_readings(samples, model),
               reference_readings(samples, params, torch.float64, hidden_layers))
    assert all(gap[k] <= TOL[k] for k in TOL), gap


@pytest.mark.parametrize("reorder", [None, "rcm"])
def test_receiver_gather_backward_matches_indexing(samples, reorder):
    """The receiver rows' gather of the edge update and its gradient, the
    segment sum over the receiver-major layout, against torch's indexing:
    that sum of any cotangent is the fp64 ``index_add_`` rounded once; and
    in the edge update, with W_e = I, so that e's gradient is the gathered
    rows' cotangent itself, p_r's gradient is that cotangent's correctly
    rounded sum, bit for bit, and the forward the composition's with
    ``p_r[receivers]``."""
    batch = packed(samples, reorder)
    Np, Ep = batch.num_nodes_padded, batch.num_edges_padded
    rcv = batch.receivers.long()

    def rounded_sum(g):  # the segment sum adds in fp64 and rounds once
        return torch.zeros(Np, g.shape[1], dtype=torch.float64).index_add_(
            0, rcv, g.double()).float()

    g = torch.randn(Ep, 5)
    dx = csr_segment_sum(g, batch.receivers, batch.edge_block_tile, Np, batch.tile)
    assert torch.equal(dx.float(), rounded_sum(g))
    rng = np.random.default_rng(6)
    f32 = lambda *s, scale=1.0: torch.as_tensor(  # noqa: E731
        (rng.normal(size=s) * scale).astype(np.float32))
    p_r, e = f32(Np, L).requires_grad_(True), f32(Ep, L).requires_grad_(True)
    floats = [torch.zeros(Np, L), p_r, e, torch.eye(L), torch.zeros(L), f32(L, L, scale=L**-0.5),
              f32(L), f32(L, L, scale=L**-0.5), f32(L), torch.ones(L), torch.zeros(L)]
    mask = (batch.edge_gid < batch.n_graphs).float()[:, None]
    view = (batch.snd_run_perm, batch.snd_run_sorted, batch.snd_block_tile)
    e_new, _ = mgn_edge.edge_update(*grouped(floats), mask, batch.senders, batch.receivers,
                                    batch.edge_block_tile, view, batch.tile)
    assert torch.equal(e_new, edge_update_composition(batch, *floats, mask)[0])
    de, dp_r = torch.autograd.grad(e_new, (e, p_r), torch.randn(Ep, L))
    assert de.abs().max() > 0
    assert torch.equal(dp_r, rounded_sum(de))


@pytest.mark.parametrize("field", ["node_inputs", "node_targets"])
@pytest.mark.parametrize("reorder", [None, "rcm"])
def test_node_fields_survive_packing(samples, field, reorder):
    host = pack_batch(samples, n_graphs=4, reorder=reorder)
    for batch in (host, host.to("cpu")):
        back = unpack_predictions(batch, getattr(batch, field))
        assert len(back) == len(samples)
        for got, s in zip(back, samples):
            np.testing.assert_array_equal(got, getattr(s, field))
        pad = np.asarray(getattr(batch, field))[sum(s.num_nodes for s in samples):]
        assert not pad.any()


def test_node_fields_are_given_for_every_sample_or_none(samples):
    bare = [GraphSample(**{f.name: getattr(s, f.name) for f in dataclasses.fields(GraphSample)})
            for s in samples]
    batch = pack_batch(bare)
    assert batch.node_inputs is None and batch.node_targets is None
    with pytest.raises(ValueError, match="node_inputs"):
        pack_batch([samples[0], bare[1]])


def test_blocks_hold_their_own_weights(samples):
    model = make_model(samples)
    params = dict(model.named_parameters())
    # the benchmark's weights are named and shaped as the port's
    spec = arch.parameter_spec(CFG)
    assert [(n, s) for n, s, _ in spec] == [(n, tuple(p.shape)) for n, p in params.items()]
    assert len({p.data_ptr() for p in params.values()}) == len(params)
    kernels = [params[f"blocks.{k}.edge_mlp.lin0.kernel"] for k in range(BLOCKS)]
    assert all(not torch.equal(a, b) for i, a in enumerate(kernels) for b in kernels[i + 1:])
    published = mgn.MeshGraphNets(latent_size=128, message_passing_steps=15)
    per_block = sum(p.numel() for p in published.blocks[0].parameters())
    assert per_block == (3 * 128 + 2 * 128) * 128 + 2 * 2 * 128 * 128 + 6 * 128 + 4 * 128
    assert sum(p.numel() for p in published.blocks.parameters()) == 15 * per_block


def test_spans_are_recorded(samples):
    model = make_model(samples)
    trainer = Trainer(model=model, learning_rate=LR, objective=mgn.objective, device="cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        trainer.train_step(packed(samples))
    rec = profiling.recorded()
    forward = rec.named("step.forward")[0].id
    for name, count in (("mgn.encode", 1), ("mgn.edge", BLOCKS), ("mgn.node", BLOCKS),
                        ("mgn.decode", 1)):
        spans = rec.named(name)
        assert len(spans) == count and all(s.parent == forward for s in spans), name
    assert [s.attrs["block"] for s in rec.named("mgn.edge")] == list(range(BLOCKS))
    assert [s.attrs["block"] for s in rec.named("mgn.node")] == list(range(BLOCKS))


def spare_capacity_pair(samples, reorder: str | None):
    """The samples packed twice at one node capacity (5 node tiles of 32,
    so real edges fill several receiver runs): at the layout's own edge
    capacity, and with spare capacity on its last tile as a loader's
    bucket gives it."""
    def pack(pad_edges: int | None):
        return pack_batch(samples, n_graphs=len(samples) + 1, pad_nodes=160,
                          pad_edges=pad_edges, tile=32, reorder=reorder).to("cpu")

    return pack(None), pack(12 * EDGE_BLOCK)


def step_readings(samples, batch) -> dict:
    """The output, the loss and every parameter's gradient of one step."""
    model = make_model(samples)
    out = model(batch)
    loss = mgn.mgn_loss(batch, out, model)
    names, params = zip(*model.named_parameters())
    return {"output": out.detach(), "loss": loss.detach(),
            **dict(zip(names, torch.autograd.grad(loss, params)))}


@pytest.mark.parametrize("reorder", [None, "rcm"])
def test_result_does_not_depend_on_spare_edge_capacity(samples, reorder):
    """The edge stream stops at the last real slot: a batch with spare edge
    capacity runs the very computation of one without, and gives the same
    output, loss and gradients to the last bit."""
    tight, spare = spare_capacity_pair(samples, reorder)
    n = mgn.live_edges(tight).n
    assert n == tight.num_edges_padded < spare.num_edges_padded
    assert mgn.live_edges(spare).n == n
    for name in ("senders", "receivers", "edge_gid"):
        assert torch.equal(getattr(tight, name), getattr(spare, name)[:n]), name
    assert torch.equal(tight.edge_block_tile, spare.edge_block_tile[:n // EDGE_BLOCK])
    assert tight.num_nodes_padded == spare.num_nodes_padded
    # the sender views differ in length: the spare slots send from the last node
    assert len(tight.snd_run_perm) < len(spare.snd_run_perm)
    want, got = step_readings(samples, tight), step_readings(samples, spare)
    assert want.keys() == got.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_edge_stream_runs_on_live_slots(samples, monkeypatch):
    """On a batch with spare edge capacity, the edge MLPs see the live slots
    only (the encoder's first layer, and each block's fused edge update),
    ``mgn.edge_rows`` counts them once a block, and ``live_slots``
    synchronizes once for two forwards."""
    model = make_model(samples)
    batch = packed(samples)
    rows: list[int] = []
    hooks = [model.edge_encoder.lin0.register_forward_hook(
        lambda m, args, out: rows.append(args[0].shape[0]))]
    plain = mgn_edge.edge_update_reference

    def seen(*args):
        rows.append(args[2].shape[0])
        return plain(*args)

    monkeypatch.setattr(mgn_edge, "edge_update_reference", seen)
    layers = 1 + BLOCKS
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            with torch.no_grad():
                for _ in range(2):
                    model(batch)
    finally:
        for h in hooks:
            h.remove()
    rec = profiling.recorded()
    n = mgn.live_edges(batch).n
    assert 0 < n < batch.num_edges_padded
    assert rec.counters["mgn.edge_rows"] == 2 * BLOCKS * n
    assert rows == 2 * [n] * layers
    assert rec.counters["host_sync.live_slots"] == 1
    assert rec.counted("host_sync") == 1


def edge_update_problem(samples, seed: int = 4) -> tuple:
    """The edge update's inputs over every slot of a batch with spare edge
    capacity (``spare_capacity_pair``): its last node tile's blocks hold
    only padding, so the kernel's 64-slot tiles there do too. Returns
    (the batch, the differentiable inputs, the mask)."""
    _, batch = spare_capacity_pair(samples, "rcm")
    gid = batch.edge_gid.view(-1, EDGE_BLOCK)
    assert (gid >= batch.n_graphs).all(dim=1).any() and (gid < batch.n_graphs).any()
    rng = np.random.default_rng(seed)
    f32 = lambda *s, scale=1.0: torch.as_tensor(  # noqa: E731
        (rng.normal(size=s) * scale).astype(np.float32))
    Np, Ep = batch.num_nodes_padded, batch.num_edges_padded
    w = lambda: f32(L, L, scale=L**-0.5)  # noqa: E731
    floats = (f32(Np, L), f32(Np, L), f32(Ep, L), w(), f32(L), w(), f32(L), w(), f32(L),
              1 + f32(L, scale=0.1), f32(L, scale=0.1))
    mask = (batch.edge_gid < batch.n_graphs).float()[:, None]
    return batch, [t.requires_grad_(True) for t in floats], mask


def grouped(floats) -> tuple:
    """``edge_update``'s tensors from (p_s, p_r, e, w_e, b0, w1, b1, w2, b2,
    gamma, beta): the later layers' weights and biases as one sequence."""
    return (*floats[:5], tuple(floats[5:9]), *floats[9:])


def edge_update_composition(batch, p_s, p_r, e, w_e, b0, w1, b1, w2, b2, gamma, beta, mask):
    """The edge update as the blocks composed it before ``mgn_edge``: the
    two endpoint gathers (the receivers' by plain indexing, whose gradient
    is ``index_add_``'s sum), the MLP's modules' operations, the mask and
    the residual, all under autograd."""
    view = (batch.snd_run_perm, batch.snd_run_sorted, batch.snd_block_tile)
    pre = (sender_gather_one(p_s, batch.senders, view, batch.tile)
           + p_r.index_select(0, batch.receivers) + e @ w_e + b0)
    y = torch.relu(torch.relu(pre) @ w1 + b1) @ w2 + b2
    e_new = torch.nn.functional.layer_norm(y, (L,), gamma, beta, mgn.LN_EPS) * mask
    return e_new, e + e_new


@pytest.mark.parametrize("used", ["both", "e_new"])
def test_edge_update_matches_the_autograd_composition(samples, used):
    """``mgn_edge.edge_update`` on CPU tensors (its plain forward, its own
    backward) against autograd through the composition it replaced, on a
    batch with spare edge capacity and tiles of only padding: the forward
    bit-equal; every gradient (both projections, e, the weights, biases and
    the LayerNorm's scale and offset) to 1e-6 of its norm, the backward
    running the same ATen operations on the same saved tensors in
    possibly another order of the last sums; with both outputs used, and
    with e + e' unused (the last block's), whose gradient stays None."""
    batch, floats, mask = edge_update_problem(samples)
    layout = (batch.senders, batch.receivers, batch.edge_block_tile,
              (batch.snd_run_perm, batch.snd_run_sorted, batch.snd_block_tile), batch.tile)
    got = mgn_edge.edge_update(*grouped(floats), mask, *layout)
    want = edge_update_composition(batch, *floats, mask)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert not got[0][mask[:, 0] == 0].any()
    rng = np.random.default_rng(5)
    cots = [torch.as_tensor(rng.normal(size=t.shape).astype(np.float32)) for t in got]
    k = 2 if used == "both" else 1
    g_got = torch.autograd.grad(got[:k], floats, cots[:k])
    g_want = torch.autograd.grad(want[:k], floats, cots[:k])
    names = ("p_s", "p_r", "e", "w_e", "b0", "w1", "b1", "w2", "b2", "gamma", "beta")
    for name, a, b in zip(names, g_got, g_want):
        assert float(b.norm()) > 0, name
        assert float((a - b).norm()) <= 1e-6 * float(b.norm()), name


def test_edge_update_without_a_sender_view_is_forward_only(samples):
    batch, floats, mask = edge_update_problem(samples)
    layout = (batch.senders, batch.receivers, batch.edge_block_tile, None, batch.tile)
    with torch.no_grad():
        e_new, e_sum = mgn_edge.edge_update(*grouped(floats), mask, *layout)
    assert torch.equal(e_sum, floats[2].detach() + e_new)
    with pytest.raises(ValueError, match="sender view"):
        mgn_edge.edge_update(*grouped(floats), mask, *layout)


class KernelStub:
    """The edge update's kernel route on CPU tensors: the wrapper's checks,
    outputs and counts run as on the card, and the "launch" fills the
    outputs with the plain version's values."""

    def __init__(self, monkeypatch):
        real = mgn_edge.cuda_build
        self.launches = real.launches
        lib = type("Lib", (), {"pdg_mgn_edge_fwd_parts": staticmethod(lambda: 5)})()
        stub = type("CudaBuild", (), {
            "device_kind": staticmethod(lambda who, *tensors: "cuda"),
            "library": staticmethod(lambda name: type("Built", (), {"lib": lib})()),
            "launch": staticmethod(self.launch), "launches": real.launches})
        monkeypatch.setattr(mgn_edge, "cuda_build", stub)
        monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())

    def launch(self, kernel, entry, *args):
        assert (kernel, entry) == ("mgn_edge_fwd", "pdg_mgn_edge_fwd")
        *inputs, e_new, e_sum = args[:16]
        saved, (wsplit, n, width, parts) = args[16:21], args[21:]
        assert wsplit.shape == (3, mgn_edge.TERMS, mgn_edge.WIDTH, mgn_edge.WIDTH)
        assert (n, width, parts) == (inputs[2].shape[0], mgn_edge.WIDTH, 5)
        p_s, p_r, e, snd, rcv, mask, w_e, b0 = inputs[:8]
        new, total, kept = mgn_edge.edge_update_reference(
            p_s, p_r, e, w_e, b0, inputs[8:12], *inputs[12:14], mask, snd, rcv)
        e_new.copy_(new)
        e_sum.copy_(total)
        for out, value in zip(saved, kept):
            if out is not None:
                out.copy_(value)
        self.launches[kernel] += 1


def test_fused_rows_are_counted_where_the_kernel_runs(samples, monkeypatch):
    """``mgn.edge_fused_rows`` counts the live slots of every block whose
    edge update ran the kernel: none on the CPU's plain path; with the
    kernel route taken (a stub in place of the launch), S · n over a
    forward, as ``mgn.edge_rows``, and one launch a block."""
    model = mgn.MeshGraphNets(latent_size=mgn_edge.WIDTH, message_passing_steps=BLOCKS,
                              stats=mgn.compute_mgn_stats(samples),
                              generator=torch.Generator().manual_seed(0))
    batch = packed(samples)
    n = mgn.live_edges(batch).n

    def forward_counters():
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            with torch.no_grad():
                out = model(batch)
        return out, profiling.recorded().counters

    want, counters = forward_counters()
    assert counters["mgn.edge_rows"] == BLOCKS * n
    assert "mgn.edge_fused_rows" not in counters
    stub = KernelStub(monkeypatch)
    before = stub.launches["mgn_edge_fwd"]
    got, counters = forward_counters()
    assert counters["mgn.edge_fused_rows"] == counters["mgn.edge_rows"] == BLOCKS * n
    assert stub.launches["mgn_edge_fwd"] - before == BLOCKS
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", [None, "width", "dtype", "shape", "layout", "depth"])
def test_kernel_route_refuses_what_it_was_not_built_for(samples, monkeypatch, case):
    """On the kernel's route the wrapper takes L = 128 in fp32 and raises on
    another L, a dtype other than fp32, a wrong shape, an index of another
    type or an MLP of another depth than 2 hidden layers."""
    batch, _, mask = edge_update_problem(samples)
    KernelStub(monkeypatch)
    W = mgn_edge.WIDTH if case != "width" else L
    Np, Ep = batch.num_nodes_padded, batch.num_edges_padded
    shapes = [(Np, W), (Np, W), (Ep, W)] + [(W, W), (W,)] * 3 + [(W,), (W,)]
    floats = [torch.zeros(shape) for shape in shapes]
    senders = batch.senders
    if case == "dtype":
        floats[2] = floats[2].double()
    elif case == "shape":
        floats[2] = floats[2][:-1]
    elif case == "layout":
        senders = senders.long()
    args = grouped(floats)
    if case == "depth":
        args = (*args[:5], args[5] + args[5][2:], *args[6:])
    layout = (senders, batch.receivers, batch.edge_block_tile, None, batch.tile)
    with torch.no_grad():
        if case is None:
            e_new, _ = mgn_edge.edge_update(*args, mask, *layout)
            assert e_new.shape == (Ep, W)
            return
        with pytest.raises(ValueError, match="mgn_edge_update"):
            mgn_edge.edge_update(*args, mask, *layout)


def test_eval_step_reads_the_objective(samples):
    model = make_model(samples)
    trainer = Trainer(model=model, learning_rate=LR, objective=mgn.objective, device="cpu")
    batch = packed(samples)
    terms = trainer.eval_step(batch)
    with torch.no_grad():
        total = mgn.mgn_loss(batch, model(batch), model)
    assert float(terms["total"]) == float(terms["mse"]) == float(total)


def test_one_device_only(samples):
    model = make_model(samples)
    with pytest.raises(ValueError, match="halo"):
        model(packed(samples), halo=object())
    trainer = Trainer(model=model, objective=mgn.objective, device="cpu", group=object())
    with pytest.raises(ValueError, match="one device"):
        trainer.train_step(packed(samples))


def test_pdivgnn_objective_needs_stats(samples):
    """The default objective is P-DivGNN's, which reads the trainer's stats
    (which may be set after construction, as a resumed run sets them)."""
    trainer = Trainer(model=make_model(samples), device="cpu")
    with pytest.raises(ValueError, match="stats"):
        trainer.loss(packed(samples))


def tiny_cell() -> tuple[dict, dict]:
    """``train.mgn.fp32`` at a tiny size on the CPU."""
    work = registry.cell("train.mgn.fp32")
    cfg, traffic = registry.config(work), registry.traffic(work["traffic"])
    cfg.update(latent_size=16, message_passing_steps=3, batch_size=2)
    traffic["pool"] = dict(traffic["pool"], meshes=6, global_mesh_refinement_size=12.0,
                           hole_refinement_factor=2.0)
    traffic.update(warmup_steps=1, trace_steps=2)
    return cfg, traffic


@pytest.mark.parametrize("fault", (None,) + FAULTS)
def test_benchmark_cell_judges_the_program(fault):
    """The benchmark's tiny loop reads the sound program correct and each
    planted fault not."""
    cfg, traffic = tiny_cell()
    with planted(fault, cfg["arch"]) if fault else contextlib.nullcontext():
        out = train.run(cfg, traffic, 2**31 + 11, 0.5, False, "cpu", time.perf_counter(),
                        workers=1)
    correct, checks = judged(out["numbers"], limits("train.mgn.fp32"))
    assert correct == (fault is None), checks
    assert out["attempted"] > 0 and out["failed"] == 0 and out["train_edges_per_s"] > 0


def test_benchmark_reads_the_edge_padding_share(monkeypatch):
    """``mgn.edge_padding_share`` over a traced window of the tiny cell: the
    edge stream's rows against the blocks' real edges, each block's rows
    whole edge blocks of the live slots; None where the program counts no
    rows, as a program without the counter."""
    cfg, traffic = tiny_cell()
    out = train.run(cfg, traffic, 2**31 + 11, 0.5, True, "cpu", time.perf_counter(), workers=1)
    run = Run(cfg=cfg, unit=train.UNIT, units=out["units"], trace=out["trace"], kernels={})
    reader = registry.metric_reader("mgn.edge_padding_share")
    rows = profiling.recorded().counters["mgn.edge_rows"]
    S = cfg["message_passing_steps"]
    assert rows % (S * EDGE_BLOCK) == 0
    edges = sum(u["E"] for u in out["units"])
    assert S * edges <= rows < sum(S * u["slots"] for u in out["units"])
    assert reader.read(run) == pytest.approx(100 * (1 - S * edges / rows))
    rec = profiling.recorded()
    rec.counters.pop("mgn.edge_rows")
    monkeypatch.setattr(profiling, "recorded", lambda: rec)
    assert reader.read(run) is None


def test_benchmark_reads_the_edge_fused_share(monkeypatch):
    """``mgn.edge_fused_share`` over a traced window of the tiny cell: 100
    where every block's edge update took the kernel's route (a stub in
    place of the launch, as on the card); None where the program counts no
    fused rows, as on the CPU's plain path or in a program without the
    counter. The kernel is built for L = 128, the published width."""
    cfg, traffic = tiny_cell()
    cfg["latent_size"] = mgn_edge.WIDTH
    reader = registry.metric_reader("mgn.edge_fused_share")

    def traced_run():
        out = train.run(cfg, traffic, 2**31 + 13, 0.5, True, "cpu", time.perf_counter(),
                        workers=1)
        return Run(cfg=cfg, unit=train.UNIT, units=out["units"], trace=out["trace"], kernels={})

    assert reader.read(traced_run()) is None
    KernelStub(monkeypatch)
    run = traced_run()
    rec = profiling.recorded()
    assert rec.counters["mgn.edge_fused_rows"] == rec.counters["mgn.edge_rows"] > 0
    assert reader.read(run) == 100.0
    rec.counters.pop("mgn.edge_fused_rows")
    monkeypatch.setattr(profiling, "recorded", lambda: rec)
    assert reader.read(run) is None


def test_benchmark_reads_the_edge_kernel_roofline():
    """``mgn_edge_fwd_roofline`` over a hand-made trace of a step at the
    cell's sizes: the kernel's least time, the larger of its bytes over HBM's
    rate and its products as six bf16 products each at the bf16 peak (here
    the bytes), over the device time of its launches and its weight split's;
    None in a trace without its launches, as a program without the kernel
    gives. The cell's configuration names only #3: the reader takes the
    kernel's own file."""
    from perfbench.harness.trace import Trace, merge
    from perfbench.harness.yardstick import HBM_BYTES_PER_S, PEAK_FLOPS

    cfg = {"latent_size": 128, "stream_dtype": "float32"}
    E, N, L = 237_000, 42_600, 128
    reader = registry.metric_reader("mgn_edge_fwd_roofline")

    def run_of(dev):
        trace = Trace(device=dev, host=[], start_us=0.0, end_us=2000.0)
        trace.merged = merge([(s, s + d) for _, _, s, d in dev])
        return Run(cfg=cfg, unit="step", units=[{"E": E, "N": N}], trace=trace,
                   kernels=registry.kernels(["segment_sum_csr"]))

    other = ("void at::native::elementwise_kernel<128, 4>()", "kernel", 1700.0, 50.0)
    launch = [("(anonymous namespace)::mgn_split_weights_kernel(float const*)", "kernel", 0.0, 2.0),
              ("(anonymous namespace)::mgn_edge_fwd_kernel((anonymous namespace)::EdgeArgs)",
               "kernel", 2.0, 800.0)]
    dev = launch + [(n, c, s + 810.0, d) for n, c, s, d in launch] + [other]
    n_bytes = 4 * (6 * E * L + 2 * N * L + 5 * E + 3 * L * L + 5 * L)
    t_ops = 6 * (6 * L * L * E) / PEAK_FLOPS["bfloat16"]
    assert n_bytes / HBM_BYTES_PER_S > t_ops
    want = 100 * 2 * (n_bytes / HBM_BYTES_PER_S) / (2 * 802e-6)
    assert reader.read(run_of(dev)) == pytest.approx(want)
    assert 25 < want < 35
    assert reader.read(run_of([other])) is None
