"""The training traffic: ``Trainer.train_step`` back to back over
``GraphLoader``'s epochs, as the port's runner builds them, with no eval
and no checkpoint.

Set-up makes the mesh pool (the same for every seed) and, from the seed,
the targets and the initial weights; it builds the model, the trainer and
the loader (with the traffic's loader seed), and drives the trainer
through its first steps over the loader's first epoch, whose batches all
differ: those steps are the ones the reference follows. The window then
takes the same trainer and the same feed on. Nothing of the program is
read for the yardstick but its outputs: the losses, Adam's moments, the
parameters, and each batch's real edges and slots.

What belongs to one architecture (its inputs, model, trainer, weights and
plain reference) comes from the module that the configuration's ``arch``
names (``arch/<arch>.py``); this driver holds the rest.
"""

from __future__ import annotations

import contextlib
import gc
import time

import numpy as np
import torch

from perfbench.harness import registry
from perfbench.harness.common import peak_bytes, reset_peak, say_setup, sync
from perfbench.harness.compare import control_args, train_details, train_numbers
from perfbench.inputs.pool import PoolBuilder
from perfbench.reference.model import adam_update

RECORDED_STEPS = 3
UNIT = "step"


def make_inputs(cfg: dict, traffic: dict, seed: int, workers: int | None = None,
                pool: PoolBuilder | None = None) -> dict:
    """The pool (built, or waited for where ``pool`` builds it) and what the
    architecture draws over it from the seed."""
    pool = (pool or PoolBuilder(traffic["pool"], workers)).result()
    return {"pool": pool, "seed": seed, "loader_seed": traffic["loader_seed"],
            **registry.arch(cfg["arch"]).draw_inputs(pool, seed)}


def first_groups(n_meshes: int, batch_size: int, seed: int, count: int) -> list[np.ndarray]:
    """The mesh ids of the first ``count`` batches of a shuffled loader
    seeded with ``seed``: one permutation, cut into batches (the JAX
    loader's order)."""
    order = np.arange(n_meshes)
    np.random.default_rng(seed).shuffle(order)
    return [order[i * batch_size:(i + 1) * batch_size] for i in range(count)]


class Program:
    """The system under test: trainer, loader and the feed the window runs."""

    def __init__(self, cfg: dict, traffic: dict, inputs: dict, device: str):
        self.device = torch.device(device)
        arch = registry.arch(cfg["arch"])
        self.initial = arch.draw_weights(cfg, inputs["seed"], self.device)
        self.trainer, self.loader = arch.build_program(cfg, traffic, inputs, self.initial,
                                                       self.device)
        self.feed = self._feed()
        self.shapes: dict[int, dict] = {}

    def _feed(self):
        from p_div_gnn_tpu_torch.train.data import prefetch

        while True:
            yield from prefetch(self.loader, self.device)

    def step(self) -> tuple[dict, torch.Tensor]:
        """One step on the feed's next batch: (its shapes, its loss)."""
        batch = next(self.feed)
        aux = self.trainer.train_step(batch)
        return self.shape(batch), aux["total"]

    def shape(self, batch) -> dict:
        key = id(batch)  # the entry holds the batch, so its id is not reused
        if key not in self.shapes:  # once per layout: reading it synchronises
            self.shapes[key] = {"E": int((batch.edge_gid < batch.n_graphs).sum()),
                                "N": int((batch.node_gid < batch.n_graphs).sum()),
                                "slots": int(batch.num_edges_padded), "batch": batch}
        return self.shapes[key]

    def first_steps(self, n: int) -> dict:
        """Run the first ``n`` steps and read what the reference follows."""
        model, opt = self.trainer.model, None
        losses, grad = [], {}
        for k in range(n):
            _, loss = self.step()
            losses.append(loss)
            if k == 0:
                opt = self.trainer.optimizer
                beta1 = opt.param_groups[0]["betas"][0]
                grad = {name: opt.state[p]["exp_avg"].detach().double() / (1 - beta1)
                        for name, p in model.named_parameters()}
        delta = {name: p.detach().double() - self.initial[name].double()
                 for name, p in model.named_parameters()}
        return {"losses": [float(v) for v in losses], "grad": grad, "delta": delta}

    def close(self) -> None:
        self.feed.close()
        del self.trainer, self.loader, self.shapes, self.initial


def reference_first_steps(cfg: dict, inputs: dict, device: str,
                          dtype: torch.dtype = torch.float64, stream: torch.dtype | None = None,
                          tf32: bool = False, n: int = RECORDED_STEPS) -> dict:
    """The reference's first ``n`` steps from the same weights on the same
    batches: losses, the first gradient and the change over the steps."""
    arch = registry.arch(cfg["arch"])
    stats = arch.reference_stats(inputs)
    groups = first_groups(len(inputs["pool"]), cfg["batch_size"], inputs["loader_seed"], n)
    params = {k: v.to(dtype).requires_grad_(True)
              for k, v in arch.draw_weights(cfg, inputs["seed"], device).items()}
    start = {k: v.detach().clone() for k, v in params.items()}
    state: dict = {}
    losses, grad = [], {}
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        for k, ids in enumerate(groups):
            batch = arch.reference_batch(inputs, ids, device)
            total = arch.reference_loss(params, batch, stats, cfg, stream)
            grads = dict(zip(params, torch.autograd.grad(total, list(params.values()))))
            losses.append(float(total.detach()))
            if k == 0:
                grad = {name: g.detach().double() for name, g in grads.items()}
            adam_update(params, grads, state, cfg["learning_rate"])
            del batch, total, grads
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    delta = {k: (params[k].detach() - start[k]).double() for k in params}
    return {"losses": losses, "grad": grad, "delta": delta}


def run(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, workers: int | None = None, pool: PoolBuilder | None = None) -> dict:
    """One run of a training cell; see ``perfbench/run.py`` for its result."""
    from perfbench.harness.trace import Spans, traced

    marks = [("start", t_start)]
    inputs = make_inputs(cfg, traffic, seed, workers, pool)
    marks.append(("pool", time.perf_counter()))
    prog = Program(cfg, traffic, inputs, device)
    marks.append(("program", time.perf_counter()))
    readings = prog.first_steps(RECORDED_STEPS)
    marks.append(("recorded steps", time.perf_counter()))
    for _ in range(traffic["warmup_steps"]):
        prog.step()
    sync(device)
    marks.append(("warm-up steps", time.perf_counter()))
    say_setup(marks)
    out: dict = {"units": [], "spans": {}}
    setup_peak = peak_bytes(device)
    reset_peak(device)
    losses = []
    if trace:
        spans = Spans()
        with traced(out, spans, device):
            for _ in range(traffic["trace_steps"]):
                with spans("train_step"):
                    shape, loss = prog.step()
                out["units"].append(shape)
                losses.append(loss)
        out["spans"] = spans.durations()
    else:
        t0 = time.perf_counter()
        out["setup_s"] = t0 - t_start
        edges = 0
        while True:
            shape, loss = prog.step()
            edges += shape["E"]
            losses.append(loss)
            if time.perf_counter() - t0 >= seconds:
                break
        sync(device)
        window = time.perf_counter() - t0
        out["train_edges_per_s"] = edges / window
    out["peak_mem_gib"] = peak_bytes(device) / 2**30
    out["memory_peak_bytes"] = max(setup_peak, peak_bytes(device))
    out["attempted"] = len(losses)
    out["failed"] = int((~torch.isfinite(torch.stack(losses))).sum())
    out["units"] = [{k: v for k, v in u.items() if k != "batch"} for u in out["units"]]
    prog.close()
    del prog, losses
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_first_steps(cfg, inputs, device, stream=stream_dtype(cfg))
    out["numbers"] = train_numbers(readings, ref)
    return out


def stream_dtype(cfg: dict) -> torch.dtype | None:
    return None if cfg["stream_dtype"] == "float32" else getattr(torch, cfg["stream_dtype"])



def calibration_rows(cfg: dict, traffic: dict, seed: int, seconds: float, do_control: bool,
                     do_faults: bool):
    """(kind, numbers) of the program's first steps and, where asked, of the
    control and of each planted fault, all against the reference, on the
    card (``calibrate.py``)."""
    from perfbench.harness.faults import FAULTS, planted

    inputs = make_inputs(cfg, traffic, seed)
    ref = reference_first_steps(cfg, inputs, "cuda", stream=stream_dtype(cfg))
    kinds = ["program"] + (["control"] if do_control else []) + (list(FAULTS) if do_faults else [])
    for kind in kinds:
        if kind == "control":
            got = reference_first_steps(cfg, inputs, "cuda", **control_args(cfg))
        else:
            with planted(kind, cfg["arch"]) if kind in FAULTS else contextlib.nullcontext():
                prog = Program(cfg, traffic, inputs, "cuda")
                got = prog.first_steps(RECORDED_STEPS)
                prog.close()
                del prog
        yield kind, {**train_numbers(got, ref), **train_details(got, ref)}
        gc.collect()
        torch.cuda.empty_cache()
