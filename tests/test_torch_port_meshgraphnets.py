"""MeshGraphNets on the port's training path (``models/meshgraphnets.py``)
against the plain reference that the benchmark holds it to
(``perfbench/reference/meshgraphnets.py``, plain torch in fp64), on seeded
random weights at a small size (L = 16, 3 blocks, 3 toy meshes): the
output, the loss, every parameter's gradient and one Adam step through
``Trainer``; the same reference in bfloat16 fails one of those
tolerances. Also: the receiver gather's backward against torch's
indexing, the per-node fields through packing and unpacking, the blocks'
own weights, the ``mgn.*`` spans, the edge stream on the batch's live
slots (the same result bit for bit whatever the spare edge capacity, the
rows the edge MLPs see, the one sync), and the benchmark's cell at a tiny
size with its faults."""

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
from p_div_gnn_tpu_torch.ops.gather import receiver_gather
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


def make_model(samples, seed: int = 0) -> mgn.MeshGraphNets:
    return mgn.MeshGraphNets(latent_size=L, message_passing_steps=BLOCKS,
                             stats=mgn.compute_mgn_stats(samples),
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


def reference_readings(samples, params: dict, dtype: torch.dtype) -> dict:
    """The reference's output (in the meshes' order), loss, gradients and
    one Adam step, computed in ``dtype``."""
    p = {k: v.detach().to(dtype).requires_grad_(True) for k, v in params.items()}
    batch, stats = ref_batch(samples), ref_stats(samples)
    out = ref.forward(p, batch, stats, BLOCKS)
    loss = ref.loss(p, batch, stats, BLOCKS)
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


@pytest.mark.parametrize("reorder", [None, "rcm"])
def test_receiver_gather_backward_matches_indexing(samples, reorder):
    batch = packed(samples, reorder)
    x = torch.randn(batch.num_nodes_padded, 5, dtype=torch.float32, requires_grad=True)
    g = torch.randn(batch.num_edges_padded, 5)
    out = receiver_gather(x, batch.receivers, batch.edge_block_tile, batch.tile)
    (dx,) = torch.autograd.grad(out, x, g)
    x_ref = x.detach().double().requires_grad_(True)
    (want,) = torch.autograd.grad(x_ref[batch.receivers.long()], x_ref, g.double())
    assert torch.equal(out, x.detach()[batch.receivers.long()])
    # the segment sum adds in fp64 and rounds once: the correctly rounded sum
    assert torch.equal(dx, want.float())


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


def test_edge_stream_runs_on_live_slots(samples):
    """On a batch with spare edge capacity, the edge MLPs see the live slots
    only, ``mgn.edge_rows`` counts them once a block, and ``live_slots``
    synchronizes once for two forwards."""
    model = make_model(samples)
    batch = packed(samples)
    rows: list[int] = []
    layers = [model.edge_encoder.lin0] + [b.edge_mlp.lin1 for b in model.blocks]
    hooks = [m.register_forward_hook(lambda m, args, out: rows.append(args[0].shape[0]))
             for m in layers]
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
    assert rows == 2 * [n] * len(layers)
    assert rec.counters["host_sync.live_slots"] == 1
    assert rec.counted("host_sync") == 1


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
