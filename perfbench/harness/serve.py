"""The serving traffic: closed-loop clients sharing one ``Predictor`` on a
served checkpoint. Each request is ``request_meshes`` meshes of the pool,
drawn without replacement, each under a new macroscopic stress drawn from
the checkpoint's statistics; its latency runs from the call to the
returned fields. A client sends its next request when the last returns,
until the window's time is up; the window ends when the last client's
last request has returned, so every request sent is counted. The closed
loop keeps the server at its capacity. A traced run measures the same
window first, then traces a short one of a few requests a client.

This driver is P-DivGNN's alone: it serves the configuration's committed
checkpoint through the port's ``Predictor`` and holds it to P-DivGNN's
reference. No cell serves yet, so it takes no architecture module.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import threading
import time

import numpy as np
import torch

from perfbench.harness.common import peak_bytes, say_setup, sync
from perfbench.harness.compare import control_args, serve_numbers
from perfbench.harness.registry import ROOT
from perfbench.inputs.pool import PoolBuilder
from perfbench.reference import model as ref_model
from perfbench.reference.ckpt import read_checkpoint
from perfbench.reference.data import ref_batch

CHECKED_REQUESTS = 6  # sampled from the window's requests, plus the largest
UNIT = "request"


def request(pool_size: int, n: int, stats: dict, seed: int, client: int, k: int):
    """(mesh ids, mean stresses (n, 3)) of client ``client``'s k-th
    request: the meshes are the same for every seed, so the work is; the
    stresses are the seed's."""
    ids = np.random.default_rng([3, client, k]).choice(pool_size, size=n, replace=False)
    rng = np.random.default_rng([seed, 3, client, k])
    means = stats["mean_mean_stress"] + stats["std_mean_stress"] * rng.normal(size=(n, 3))
    return ids, means.astype(np.float32)


def port_samples(pool: list[dict]) -> list:
    from p_div_gnn_tpu_torch.graphs.batching import GraphSample
    from p_div_gnn_tpu_torch.graphs.build import MeshGraph

    empty = (np.zeros(0, np.float32), np.zeros(0, np.int64), np.zeros(0, np.int64))
    return [GraphSample(
        graph=MeshGraph(pos=m["pos"], edge_index=m["edge_index"], edge_weight=m["edge_weight"],
                        faces=m["faces"], org_num_edges=m["org_num_edges"], is_periodic=True),
        mean_stress=np.zeros(3, np.float32),
        local_stress=np.zeros((len(m["pos"]), 3), np.float32),
        node_labels=m["labels"], div_data=empty[0], div_row=empty[1], div_col=empty[2])
        for m in pool]


class Clients:
    """The closed-loop clients and what they recorded."""

    def __init__(self, predictor, pool: list[dict], samples: list, traffic: dict, stats: dict,
                 seed: int):
        self.predictor, self.pool, self.samples = predictor, pool, samples
        self.traffic, self.stats, self.seed = traffic, stats, seed
        self.next_k = [0] * traffic["clients"]
        self.done: list[dict] = []
        self.errors: list[str] = []
        self.lock = threading.Lock()

    def one(self, client: int) -> None:
        k = self.next_k[client]
        self.next_k[client] += 1
        ids, means = request(len(self.pool), self.traffic["request_meshes"], self.stats,
                             self.seed, client, k)
        reqs = [dataclasses.replace(self.samples[i], mean_stress=m) for i, m in zip(ids, means)]
        t0 = time.perf_counter()
        try:
            fields = self.predictor.predict(reqs)
        except Exception as exc:  # a failed request is counted, not raised
            fields, err = None, repr(exc)
        else:
            err = None
        latency = time.perf_counter() - t0
        nodes = sum(len(self.pool[i]["pos"]) for i in ids)
        edges = sum(self.pool[i]["edge_index"].shape[1] for i in ids)
        with self.lock:
            self.done.append({"client": client, "k": k, "latency": latency, "fields": fields,
                              "ids": ids, "means": means, "N": nodes, "E": edges, "end": t0 + latency})
            if err is not None:
                self.errors.append(err)

    def loop(self, client: int, seconds: float | None, count: int | None, barrier,
             box: dict) -> None:
        barrier.wait()
        until = None if seconds is None else box["start"] + seconds
        n = 0
        while (until is None or time.perf_counter() < until) and (count is None or n < count):
            self.one(client)
            n += 1

    def run(self, seconds: float | None = None, per_client: int | None = None) -> float:
        """Run every client until ``seconds`` have passed or each has sent
        ``per_client`` requests; returns the window's start."""
        n = self.traffic["clients"]
        barrier = threading.Barrier(n + 1)
        box: dict = {}
        threads = [threading.Thread(target=self.loop, args=(c, seconds, per_client, barrier, box))
                   for c in range(n)]
        for t in threads:
            t.start()
        box["start"] = time.perf_counter()
        barrier.wait()
        for t in threads:
            t.join()
        return box["start"]


def run(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, workers: int | None = None, pool: PoolBuilder | None = None) -> dict:
    """One run of a serving cell; see ``perfbench/run.py`` for its result."""
    import p_div_gnn_tpu_torch.inference as inference
    from p_div_gnn_tpu_torch.inference import Predictor

    from perfbench.harness.trace import Spans, traced

    marks = [("start", t_start)]
    ckpt = ROOT / cfg["checkpoint"]
    _, stats = read_checkpoint(ckpt)
    pool = (pool or PoolBuilder(traffic["pool"], workers)).result()
    samples = port_samples(pool)
    marks.append(("pool", time.perf_counter()))
    predictor = Predictor(ckpt, latent_size=cfg["latent_size"],
                          message_passing_steps=cfg["message_passing_steps"],
                          scatter_impl=cfg["scatter_impl"], stream_dtype=cfg["stream_dtype"],
                          device=device)
    clients = Clients(predictor, pool, samples, traffic, stats, seed)
    marks.append(("predictor", time.perf_counter()))
    clients.run(per_client=traffic["warmup_requests"])
    sync(device)
    marks.append(("warm-up requests", time.perf_counter()))
    say_setup(marks)
    out: dict = {"units": [], "spans": {}}
    clients.done, clients.errors = [], []
    start = clients.run(seconds=seconds)
    sync(device)
    end = max(r["end"] for r in clients.done)
    out["setup_s"] = start - t_start
    meshes = sum(len(r["ids"]) for r in clients.done if r["fields"] is not None)
    out["serve_meshes_per_s"] = meshes / (end - start)
    out["spans"] = {"request": [r["latency"] for r in clients.done]}
    if trace:  # after the window, a short traced one
        spans = Spans()
        shims = {name: getattr(inference, name) for name in ("pack_batch", "unpack_predictions")}

        def shim(name: str, fn):
            def timed(*args, **kwargs):
                with spans(name):
                    return fn(*args, **kwargs)
            return timed

        predict = predictor.predict
        traced_from = len(clients.done)
        try:
            for name, fn in shims.items():
                setattr(inference, name, shim(name, fn))
            predictor.predict = shim("predict", predict)
            with traced(out, spans, device):
                clients.run(per_client=traffic["trace_requests"])
        finally:
            for name, fn in shims.items():
                setattr(inference, name, fn)
            predictor.predict = predict
        out["spans"].update(spans.durations())
        out["units"] = [{"E": r["E"], "N": r["N"]} for r in clients.done[traced_from:]]
    out["memory_peak_bytes"] = peak_bytes(device)
    out["attempted"] = len(clients.done)
    out["failed"] = sum(1 for r in clients.done if r["fields"] is None
                        or len(r["fields"]) != len(r["ids"]))
    out["errors"] = clients.errors[:3]
    done = clients.done
    del clients, predictor
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    out["numbers"] = check(cfg, pool, done, seed, device)
    return out


def checked_requests(done: list[dict], seed: int) -> list[dict]:
    """A sample of the window's requests drawn from the seed, with the
    largest among them."""
    order = sorted(done, key=lambda r: (r["client"], r["k"]))
    rng = np.random.default_rng([seed, 4])
    pick = rng.choice(len(order), size=min(CHECKED_REQUESTS, len(order)), replace=False)
    chosen = [order[i] for i in sorted(pick)]
    largest = max(order, key=lambda r: r["N"])
    return chosen + ([largest] if largest not in chosen else [])


def reference_fields(cfg: dict, pool: list[dict], req: dict, device: str,
                     dtype: torch.dtype = torch.float64, tf32: bool = False,
                     stream: torch.dtype | None = None) -> list[torch.Tensor]:
    """The reference's stress field of each mesh of a request, from the
    checkpoint's weights read by the reference's own reader."""
    params, stats = read_checkpoint(ROOT / cfg["checkpoint"])
    p = {k: torch.as_tensor(v, device=device).to(dtype) for k, v in params.items()}
    batch = ref_batch([pool[i] for i in req["ids"]], list(req["means"]), None, device)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        with torch.no_grad():
            out = ref_model.forward(p, batch, stats, cfg["message_passing_steps"],
                                    scale_output=True, stream=stream).double()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    counts = [len(pool[i]["pos"]) for i in req["ids"]]
    return list(torch.split(out, counts))


def check(cfg: dict, pool: list[dict], done: list[dict], seed: int, device: str) -> dict:
    if not done:
        return {"field_gap": float("inf")}
    _, stats = read_checkpoint(ROOT / cfg["checkpoint"])
    worst = 0.0
    for req in checked_requests(done, seed):
        if req["fields"] is None:
            return {"field_gap": float("inf")}
        refs = reference_fields(cfg, pool, req, device)
        worst = max(worst, serve_numbers(req["fields"], refs, stats["std_local_stress"])["field_gap"])
    return {"field_gap": worst}


def calibration_rows(cfg: dict, traffic: dict, seed: int, seconds: float, do_control: bool,
                     do_faults: bool):
    """(kind, numbers) of the program's window and, where asked, of the
    control and of the answer altered, all against the reference, on the
    card (``calibrate.py``)."""
    from p_div_gnn_tpu_torch.inference import Predictor

    from perfbench.harness.faults import planted

    ckpt = ROOT / cfg["checkpoint"]
    _, stats = read_checkpoint(ckpt)
    pool = PoolBuilder(traffic["pool"]).result()
    samples = port_samples(pool)
    kinds = ["program"] + (["answer_altered"] if do_faults else [])
    sampled = None
    for kind in kinds:
        with planted(kind, cfg["arch"]) if kind != "program" else contextlib.nullcontext():
            predictor = Predictor(ckpt, latent_size=cfg["latent_size"],
                                  message_passing_steps=cfg["message_passing_steps"],
                                  scatter_impl=cfg["scatter_impl"],
                                  stream_dtype=cfg["stream_dtype"], device="cuda")
            clients = Clients(predictor, pool, samples, traffic, stats, seed)
            clients.run(seconds=seconds)
        sampled = checked_requests(clients.done, seed)
        refs = [reference_fields(cfg, pool, r, "cuda") for r in sampled]
        worst = max(serve_numbers(r["fields"], ref, stats["std_local_stress"])["field_gap"]
                    for r, ref in zip(sampled, refs))
        yield kind, {"field_gap": worst, "requests": len(clients.done)}
        del clients, predictor
        gc.collect()
        torch.cuda.empty_cache()
    if do_control:
        worst = 0.0
        for r in sampled:
            ref = reference_fields(cfg, pool, r, "cuda")
            low = reference_fields(cfg, pool, r, "cuda", **control_args(cfg))
            worst = max(worst, serve_numbers([x.cpu().numpy() for x in low], ref,
                                             stats["std_local_stress"])["field_gap"])
        yield "control", {"field_gap": worst}
