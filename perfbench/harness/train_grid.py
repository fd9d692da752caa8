"""The training traffic over a fixed graph: ``Trainer.train_step`` back to
back over a ``FixedGraphLoader``'s samples of node states, with no eval and
no checkpoint (GraphCast's cell).

Set-up builds the port's typed graph once (on the device where it runs its
radius query), draws the samples over it and the initial weights from the
seed, builds the model, the trainer and the loader (with the traffic's
loader seed), and drives the trainer through its first steps, which the
reference follows; the window then takes the same trainer on. A step's
``E`` is its graph's real edges over every edge set and ``N`` its real
nodes over every node set. The reference builds its own graph and takes
its own first steps with the published AdamW and clipping
(``reference/graphcast.py``); ``harness/compare.py::train_numbers`` holds
the two apart as in the other training cells.

What belongs to one architecture comes from the configuration's
``arch/<arch>.py``; the window, the readings, the memory and the
calibration rows are ``harness/train.py``'s, run with this driver's
inputs, ``Program`` and reference (``_over_fixed_graph``). The mesh pool
that ``run.py`` starts for every traffic mix is empty here (``"meshes":
0``): it is waited for at once, which keeps it in the checkout's cache.
"""

from __future__ import annotations

import contextlib

import torch

from perfbench.harness import registry
from perfbench.harness import train as loader_train
from perfbench.reference.graphcast import adamw_clip_update

RECORDED_STEPS = loader_train.RECORDED_STEPS
UNIT = "step"


def make_inputs(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """The port's typed graph on the host and what the architecture draws
    over it from the seed."""
    from p_div_gnn_tpu_torch.graphs.grid_mesh import grid_mesh_graph

    arch = registry.arch(cfg["arch"])
    spec = arch.graph_spec(cfg)
    graph = grid_mesh_graph(spec["resolution"], spec["mesh_levels"], spec["radius_fraction"],
                            device=device)
    fixed = {"graph": graph, "samples": traffic["samples"]}
    return {"graph": graph, "graph_spec": spec, "seed": seed,
            "loader_seed": traffic["loader_seed"], **arch.draw_inputs(fixed, seed)}


class Program(loader_train.Program):
    """``harness/train.py``'s program over a fixed graph's samples."""

    def shape(self, batch) -> dict:
        key = id(batch)
        if key not in self.shapes:
            g = batch.graph
            self.shapes[key] = {"E": sum(e.n for e in g.edges.values()),
                                "N": sum(n.n for n in g.nodes.values()),
                                "slots": sum(e.slots for e in g.edges.values()),
                                "batch": batch}
        return self.shapes[key]


def reference_first_steps(cfg: dict, inputs: dict, device: str,
                          dtype: torch.dtype = torch.float64, stream: torch.dtype | None = None,
                          tf32: bool = False, n: int = RECORDED_STEPS) -> dict:
    """The reference's first ``n`` steps from the same weights on the same
    samples, in the loader's order: losses, the first gradient as the
    update takes it (clipped) and the change over the steps. ``stream``
    must be None: the configuration streams fp32."""
    arch = registry.arch(cfg["arch"])
    stats = arch.reference_stats(inputs)
    ids = loader_train.first_groups(len(inputs["inputs"]), 1, inputs["loader_seed"], n)
    params = {k: v.to(dtype).requires_grad_(True)
              for k, v in arch.draw_weights(cfg, inputs["seed"], device).items()}
    start = {k: v.detach().clone() for k, v in params.items()}
    state: dict = {}
    losses, grad = [], {}
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        for k, sample in enumerate(ids):
            batch = arch.reference_batch(inputs, sample, device)
            total = arch.reference_loss(params, batch, stats, cfg, stream)
            grads = dict(zip(params, torch.autograd.grad(total, list(params.values()))))
            losses.append(float(total.detach()))
            clipped = adamw_clip_update(params, grads, state, cfg["learning_rate"],
                                        tuple(cfg["betas"]), cfg["weight_decay"],
                                        cfg["grad_clip_norm"])
            if k == 0:
                grad = {name: g.detach().double() for name, g in clipped.items()}
            del batch, total, grads, clipped
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    delta = {k: (params[k].detach() - start[k]).double() for k in params}
    return {"losses": losses, "grad": grad, "delta": delta}


@contextlib.contextmanager
def _over_fixed_graph(device):
    """``harness/train.py``'s loop with this kind's inputs, program and
    reference in place of the loader's: its ``run`` and
    ``calibration_rows`` read the three from their module, which this block
    points at these for its duration."""
    names = ("make_inputs", "Program", "reference_first_steps")
    saved = {name: getattr(loader_train, name) for name in names}

    def inputs(cfg, traffic, seed, workers=None, pool=None):
        if pool is not None:
            pool.result()  # the empty pool: kept in the cache, its workers stopped
        return make_inputs(cfg, traffic, seed, device)

    loader_train.make_inputs, loader_train.Program = inputs, Program
    loader_train.reference_first_steps = reference_first_steps
    try:
        yield
    finally:
        for name, value in saved.items():
            setattr(loader_train, name, value)


def run(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, workers: int | None = None, pool=None) -> dict:
    """One run of a fixed-graph training cell; see ``perfbench/run.py`` for
    its result."""
    with _over_fixed_graph(device):
        return loader_train.run(cfg, traffic, seed, seconds, trace, device, t_start, workers,
                                pool)


def calibration_rows(cfg: dict, traffic: dict, seed: int, seconds: float, do_control: bool,
                     do_faults: bool):
    """(kind, numbers) of the program's first steps and, where asked, of the
    control and of each planted fault, all against the reference, on the
    card (``calibrate.py``)."""
    with _over_fixed_graph("cuda"):
        yield from loader_train.calibration_rows(cfg, traffic, seed, seconds, do_control,
                                                 do_faults)
