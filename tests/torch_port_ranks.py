"""Rank bodies of the parallel tier's CPU tests (gloo ranks started by
``p_div_gnn_tpu_torch.parallel.launch.run_ranks``). This module imports no
JAX, so each spawned rank starts in a few seconds; the tests hold what the
ranks return against the JAX package in the parent process.

Each body is ``fn(rank, world, group, *args)`` and returns numpy arrays and
numbers."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from p_div_gnn_tpu_torch.datagen.mesher import hole_plate_mesh
from p_div_gnn_tpu_torch.datagen.opdiv import compute_op_div_matrix
from p_div_gnn_tpu_torch.graphs.batching import GraphSample
from p_div_gnn_tpu_torch.graphs.build import mesh_to_graph
from p_div_gnn_tpu_torch.graphs.container import NormStats
from p_div_gnn_tpu_torch.graphs.labels import compute_node_labels
from p_div_gnn_tpu_torch.graphs.periodic import compute_periodic_graph
from p_div_gnn_tpu_torch.models.epd import EncodeProcessDecode, Halo
from p_div_gnn_tpu_torch.parallel import collectives
from p_div_gnn_tpu_torch.parallel.dp import make_dp_eval_step, make_dp_train_step, shard_of
from p_div_gnn_tpu_torch.parallel.partition import (
    make_partitioned_forward,
    make_partitioned_train_step,
)

STATS = dict(mean_pos=50.0, std_pos=30.0, mean_mean_stress=0.1, std_mean_stress=2.0,
             mean_local_stress=0.05, std_local_stress=1.5, mean_edge_weight=20.0,
             std_edge_weight=8.0)
LAMBDA = 10.0


def sample(seed: int, size: float = 12.5) -> GraphSample:
    """A periodic plate-with-hole mesh with its divergence operator (the
    port's twin of ``test_torch_port_graphs._port_sample``)."""
    rng = np.random.default_rng(seed)
    mesh = hole_plate_mesh(100.0, 100.0, radius=float(rng.uniform(15, 30)),
                           hole_center=(50.0, 50.0), hole_refinement_factor=3.0,
                           global_mesh_refinement_size=size, seed=seed)
    return sample_from_mesh(mesh, rng)


def sample_from_mesh(mesh, rng: np.random.Generator) -> GraphSample:
    """The periodic graph, labels and divergence operator of ``mesh``, with
    a random macroscopic stress and target field from ``rng``."""
    g = compute_periodic_graph(mesh_to_graph(mesh))
    op = compute_op_div_matrix(mesh.points[:, :2], mesh.faces)
    return GraphSample(
        graph=g,
        mean_stress=rng.normal(size=3).astype(np.float32),
        local_stress=rng.normal(size=(g.num_nodes, 3)).astype(np.float32),
        node_labels=compute_node_labels(mesh),
        div_data=op.data.astype(np.float32),
        div_row=op.row.astype(np.int64),
        div_col=op.col.astype(np.int64),
    )


def model_from(state: dict, latent: int, steps: int, impl: str = "xla",
               stream_dtype: str = "float32", remat: bool = False) -> EncodeProcessDecode:
    model = EncodeProcessDecode(latent_size=latent, message_passing_steps=steps,
                                scatter_impl=impl, stream_dtype=stream_dtype,
                                remat_steps=remat)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    return model


def adam(model: torch.nn.Module) -> torch.optim.Adam:
    return torch.optim.Adam(model.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)


def _numpy(tree):
    return {k: v.detach().numpy().copy() for k, v in tree.items()}


# --- collectives ---------------------------------------------------------

def collectives_rank(rank: int, world: int, group, seed: int) -> dict:
    """Each collective's forward and backward on rank-dependent inputs
    (row r of one seeded draw), with a rank-dependent cotangent."""
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(world, world, 3, 5)).astype(np.float32)
    cts = rng.normal(size=(world, world, 3, 5)).astype(np.float32)
    out = {}
    for name in ("psum", "psum64", "all_to_all", "all_gather"):
        x = torch.tensor(xs[rank], requires_grad=True)
        if name == "psum":
            y = collectives.psum(x, group)
        elif name == "psum64":
            y = collectives.psum64(x, group)
        elif name == "all_to_all":
            y = collectives.all_to_all(x, group)
        else:
            y = collectives.all_gather(x[0], group)
        ct = torch.tensor(cts[rank][: y.shape[0]].reshape(y.shape))
        (y * ct).sum().backward()
        out[name] = (y.detach().numpy(), x.grad.numpy())
    # the async pair: issued, local work, then waited
    x = torch.tensor(xs[rank], requires_grad=True)
    pending = collectives.start_all_to_all(x, group)
    local = (x * 2).sum()
    y = pending.wait()
    (y * torch.tensor(cts[rank])).sum().backward()
    out["start_all_to_all"] = (y.detach().numpy(), x.grad.numpy(), float(local))
    grads = [torch.tensor(xs[rank][0]), torch.tensor(xs[rank][1])]
    collectives.pmean_(grads, group)
    out["pmean_"] = [g.numpy() for g in grads]
    out["identity"] = all(f(torch.ones(2), None) is not None for f in (
        collectives.psum, collectives.all_to_all))
    out["tensor"] = torch.full((3,), float(rank))  # comes back by value
    return out


# --- data parallel -------------------------------------------------------

def dp_step_rank(rank: int, world: int, group, stacked, state: dict, latent: int,
                 steps: int, impl: str) -> dict:
    """The DP eval step's prediction on this rank's shard, then one DP train
    step: the loss terms, the gradients after their mean over the ranks,
    the parameters after Adam."""
    model = model_from(state, latent, steps, impl)
    stats = NormStats.from_dict(STATS)
    local = shard_of(stacked, rank).to("cpu")
    pred = make_dp_eval_step(model, stats, group)(local)
    step = make_dp_train_step(model, stats, adam(model), group,
                              divergence_penalty=LAMBDA, optimize_divergence=True)
    aux = step(local)
    grads = {n: p.grad.detach().numpy().copy() for n, p in model.named_parameters()}
    return {"aux": {k: float(v) for k, v in aux.items()}, "grads": grads,
            "params": _numpy(model.state_dict()), "eval": pred.numpy()}


# --- edge partitioning ---------------------------------------------------

class _Spy:
    """Records the halo's collectives (issued, with their dtype and
    async_op, and waited) and the matmuls between them."""

    def __init__(self):
        self.events: list[tuple] = []

    @contextlib.contextmanager
    def installed(self):
        import torch.distributed as dist
        from torch.overrides import TorchFunctionMode

        spy = self
        real = {name: getattr(dist, name) for name in ("all_to_all_single",
                                                       "all_gather_into_tensor",
                                                       "all_gather_single") if hasattr(dist, name)}

        def wrap(name, fn):
            def call(out, inp, *args, **kwargs):
                spy.events.append(("issue", name, str(inp.dtype), kwargs.get("async_op")))
                work = fn(out, inp, *args, **kwargs)
                if work is None:
                    return None

                class Work:
                    def wait(self):
                        spy.events.append(("wait", name))
                        return work.wait()

                return Work()
            return call

        class Matmuls(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                if getattr(func, "__name__", "") in ("matmul", "__matmul__"):
                    spy.events.append(("matmul",))
                return func(*args, **(kwargs or {}))

        for name, fn in real.items():
            setattr(dist, name, wrap(name, fn))
        try:
            with Matmuls():
                yield self
        finally:
            for name, fn in real.items():
                setattr(dist, name, fn)


def partition_rank(rank: int, world: int, group, plans: dict, state: dict, latent: int,
                   steps: int, cases: list) -> dict:
    """For each (impl, halo_mode) case: the partitioned forward (stress
    units) and one partitioned train step (loss terms, averaged gradients,
    parameters after Adam) on this rank's shard; plus the collectives and
    matmuls of one forward per impl in spy mode ("xla" fp32, "fused3"
    bf16)."""
    stats = NormStats.from_dict(STATS)
    out = {}
    for impl, mode in cases:
        stacked, send_idx = plans[mode]
        local = shard_of(stacked, rank).to("cpu")
        halo = Halo(torch.as_tensor(send_idx[rank]), group)
        model = model_from(state, latent, steps, impl)
        fwd = make_partitioned_forward(model, stats, group, scale_output=True)(local, halo)
        opt = adam(model)
        step = make_partitioned_train_step(model, stats, opt, group,
                                           divergence_penalty=LAMBDA, optimize_divergence=True)
        aux = step(local, halo)
        grads = {n: p.grad.detach().numpy().copy() for n, p in model.named_parameters()}
        out[(impl, mode)] = {"fwd": fwd.numpy(), "aux": {k: float(v) for k, v in aux.items()},
                             "grads": grads, "params": _numpy(model.state_dict())}
    stacked, send_idx = plans["a2a"]
    local = shard_of(stacked, rank).to("cpu")
    halo = Halo(torch.as_tensor(send_idx[rank]), group)
    # remat: the backward runs each step's exchange and sums again, in the
    # same order on every rank
    model = model_from(state, latent, steps, "fused3", remat=True)
    make_partitioned_train_step(model, stats, adam(model), group, divergence_penalty=LAMBDA,
                                optimize_divergence=True)(local, halo)
    out["remat"] = {n: p.grad.detach().numpy().copy() for n, p in model.named_parameters()}
    for impl, sd in (("xla", "float32"), ("fused3", "bfloat16")):
        model = model_from(state, latent, steps, impl, sd)
        spy = _Spy()
        with torch.no_grad(), spy.installed():
            model(local, stats, group=group, halo=halo)
        out[("spy", impl)] = spy.events
    return out


# --- the trainer and the runner over ranks ---------------------------------

def fit_rank(rank: int, world: int, group, samples: list, state: dict, folder: str,
             toy_cfg: dict) -> dict:
    """``Trainer(group=)``: a 2-epoch fit on unshuffled shards (losses and
    parameters); a 4-epoch fit on shuffled shards against 2 epochs, a
    resume from the last checkpoint and 2 more; a step skipped for a
    non-finite gradient from one rank's shard; then the runner with
    ``data_parallel`` and ``multihost`` from a config, and its refusal of
    fused2."""
    from pathlib import Path

    from p_div_gnn_tpu_torch.parallel.dp import DPGraphLoader, pack_sharded_batch
    from p_div_gnn_tpu_torch.train import runner
    from p_div_gnn_tpu_torch.train.checkpoint import LAST_CHECKPOINT, load_checkpoint
    from p_div_gnn_tpu_torch.train.loop import Trainer

    folder = Path(folder)
    stats = NormStats.from_dict(STATS)

    def trainer(**kw):
        model = model_from(state, 8, 1)
        return Trainer(model, stats, divergence_penalty=LAMBDA, device="cpu", group=group, **kw)

    def loader(shuffle=False, seed=0):
        return DPGraphLoader(samples, 4, rank, world, shuffle=shuffle, seed=seed, device="cpu")

    out = {}
    tr = trainer(optimize_divergence=True, monitor_divergence_in_test=True)
    out["fit"] = tr.fit(loader(), loader(), epochs=2, weights_folder=folder / "fit",
                        verbose=False)
    out["fit_params"] = _numpy(tr.model.state_dict())

    kw = dict(optimize_divergence=False, monitor_divergence_in_test=False)
    tr = trainer(**kw)
    tr.fit(loader(True, 1), loader(True, 2), epochs=4, weights_folder=folder / "a",
           verbose=False)
    out["straight"] = _numpy(tr.model.state_dict())
    tr = trainer(**kw)
    lt, le = loader(True, 1), loader(True, 2)
    tr.fit(lt, le, epochs=2, weights_folder=folder / "b", verbose=False)
    tr = trainer(**kw)
    tr.init()
    sd, epoch, tr.stats = load_checkpoint(folder / "b" / LAST_CHECKPOINT, tr.model,
                                          tr.optimizer, tr.nonfinite)
    tr.model.load_state_dict(sd)
    out["resumed_at"] = epoch
    tr.fit(lt, le, epochs=4, weights_folder=folder / "b", verbose=False, start_epoch=epoch)
    out["resumed"] = _numpy(tr.model.state_dict())

    # skip_nonfinite_updates: rank 1's shard poisons the loss; the finite
    # check reads the gradients after their all-reduce, so both ranks skip
    tr = trainer(skip_nonfinite_updates=True)
    tr.init()
    batch = shard_of(pack_sharded_batch(samples, world, 2), rank)
    if rank == 1:
        batch.local_stress = batch.local_stress.copy()
        batch.local_stress[0, 0] = np.nan
    before = _numpy(tr.model.state_dict())
    tr.train_step(batch)
    out["skip"] = {"count": int(tr.nonfinite["total_notfinite"]),
                   "kept": all(np.array_equal(v, before[k])
                               for k, v in _numpy(tr.model.state_dict()).items())}

    out["runner"] = runner.main(toy_cfg["config"], device="cpu")
    try:
        runner.run_experience(**{**toy_cfg["kw"], "scatter_impl": "fused2",
                                 "results_folder": str(folder / "fused2")},
                              data_parallel=True, device="cpu")
        out["fused2"] = None
    except ValueError as exc:
        out["fused2"] = str(exc)
    return out


def dp_rank(rank: int, world: int, group, stacked, state: dict, impls: list, samples: list,
            fit_state: dict, folder: str, toy_cfg: dict) -> dict:
    """The DP train step of each impl (``dp_step_rank``, latent 16, 2 steps),
    then ``fit_rank``: one spawn for the data-parallel tests."""
    out = {impl: dp_step_rank(rank, world, group, stacked, state, 16, 2, impl)
           for impl in impls}
    out["fit"] = fit_rank(rank, world, group, samples, fit_state, folder, toy_cfg)
    return out
