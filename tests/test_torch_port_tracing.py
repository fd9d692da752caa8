"""The port's tracing (``p_div_gnn_tpu_torch/utils/profiling.py``): spans
and counters are recorded only while a ``torch.profiler`` session is open,
each session starts a new record, the training step, the loader, the
served request and the layout checks record where their work happens, and
a span's stamps lie on the exported trace's clock. The file imports no
JAX: on the card, ``python -m pytest --noconftest
tests/test_torch_port_tracing.py`` also runs the test that needs one."""

from __future__ import annotations

import json
import threading

import pytest
import torch

from p_div_gnn_tpu_torch.graphs.batching import pack_batch
from p_div_gnn_tpu_torch.graphs.container import NormStats
from p_div_gnn_tpu_torch.inference import Predictor
from p_div_gnn_tpu_torch.models.epd import EncodeProcessDecode
from p_div_gnn_tpu_torch.ops.segment import live_slots, require_consecutive_runs
from p_div_gnn_tpu_torch.train.data import GraphLoader, prefetch
from p_div_gnn_tpu_torch.train.loop import Trainer
from p_div_gnn_tpu_torch.utils import profiling
from torch_port_ranks import STATS, sample

CPU = [torch.profiler.ProfilerActivity.CPU]
PHASES = ("step.forward", "step.backward", "step.optimizer")


@pytest.fixture(scope="module")
def samples():
    return [sample(seed, size=25.0) for seed in range(3)]


def trainer(skip_nonfinite: bool = False) -> Trainer:
    torch.manual_seed(0)
    model = EncodeProcessDecode(latent_size=8, message_passing_steps=2, scatter_impl="xla")
    return Trainer(model=model, stats=NormStats(**STATS), divergence_penalty=10.0,
                   device="cpu", skip_nonfinite_updates=skip_nonfinite)


def test_off_records_nothing_and_shares_one_noop():
    with torch.profiler.profile(activities=CPU):
        pass
    assert profiling.span("a") is profiling.span("b", device=True, step=3)
    with profiling.span("a") as sp:
        sp.set(x=1)
    assert profiling.count("c") is None
    rec = profiling.recorded()
    assert rec.spans == [] and rec.counters == {}


def test_each_session_starts_afresh():
    with torch.profiler.profile(activities=CPU):
        with profiling.span("first"):
            profiling.count("c", 2)
    assert [s.name for s in profiling.recorded().spans] == ["first"]
    with torch.profiler.profile(activities=CPU):
        with profiling.span("second", request=7) as sp:
            sp.set(edges=5)
    rec = profiling.recorded()
    assert [(s.name, s.attrs) for s in rec.spans] == [("second", {"request": 7, "edges": 5})]
    assert rec.counters == {}
    assert rec.base_ns == profiling.trace_base_ns(rec.spans[0].start_ns / 1e9)


def test_spans_nest_per_thread():
    inner: dict = {}

    def other():
        with profiling.span("other") as sp:
            inner["id"] = sp.span.id

    with torch.profiler.profile(activities=CPU):
        with profiling.span("outer") as outer:
            thread = threading.Thread(target=other)
            thread.start()
            thread.join(timeout=30)
            with profiling.span("inner"):
                pass
    assert not thread.is_alive()
    by = {s.name: s for s in profiling.recorded().spans}
    assert by["inner"].parent == outer.span.id and by["outer"].parent is None
    assert by["other"].parent is None and by["other"].thread != by["outer"].thread
    assert by["outer"].start_ns <= by["inner"].start_ns <= by["inner"].end_ns <= by["outer"].end_ns


@pytest.mark.parametrize("skip_nonfinite", [False, True], ids=["adam", "adam_if_finite"])
def test_train_step_records_its_phases(samples, skip_nonfinite):
    tr = trainer(skip_nonfinite)
    batch = pack_batch(samples[:2], sender_view=False)
    tr.train_step(batch)  # untraced: no record, but counts the step
    with torch.profiler.profile(activities=CPU):
        tr.train_step(batch)
    rec = profiling.recorded()
    steps = rec.named("step")
    assert [s.attrs for s in steps] == [{"step": 1}]
    step = steps[0]
    phases = [s for s in rec.spans if s.name in PHASES]
    assert [s.name for s in phases] == list(PHASES)
    at = step.start_ns
    for s in phases:
        assert s.parent == step.id and s.attrs == {}
        assert at <= s.start_ns <= s.end_ns <= step.end_ns
        assert s.device_ms is None  # CPU tensors: no device time
        at = s.end_ns


def test_prefetch_records_wait_and_pack(samples):
    loader = GraphLoader(samples, batch_size=2, shuffle=False, cache_device_batches=False,
                         sender_view=False, device="cpu")
    with torch.profiler.profile(activities=CPU):
        batches = list(prefetch(loader, "cpu"))
    rec = profiling.recorded()
    assert len(rec.named("loader.wait")) == len(batches) + 1  # the last wait gets the end
    packs = rec.named("loader.pack")
    assert len(packs) == len(batches) == 2
    for s, batch, group in zip(packs, batches, (samples[:2], samples[2:])):
        assert s.attrs == {"edges": sum(x.num_edges for x in group),
                           "slots": batch.num_edges_padded}
        assert s.thread != rec.named("loader.wait")[0].thread


def test_predict_records_five_stages_under_one_request(samples, tmp_path):
    tr = trainer()
    tr.save(tmp_path / "model.ckpt", 1)
    pred = Predictor(tmp_path / "model.ckpt", latent_size=8, message_passing_steps=2,
                     scatter_impl="xla", device="cpu")
    stages = ["serve.pack", "serve.copy_in", "serve.forward", "serve.copy_out", "serve.unpack"]
    with torch.profiler.profile(activities=CPU):
        fields = pred.predict(samples[:2])
        pred.predict(samples[2:])
    assert [f.shape for f in fields] == [(s.num_nodes, 3) for s in samples[:2]]
    spans = profiling.recorded().spans
    assert [s.name for s in spans] == stages * 2
    assert [s.attrs["request"] for s in spans] == [0] * 5 + [1] * 5
    assert all(a.end_ns <= b.start_ns for a, b in zip(spans, spans[1:]))


def test_host_syncs_count_new_layouts_only():
    gid = torch.tensor([0, 0, 1, 1, 2, 2, 2, 2])
    receivers = torch.tensor([0, 0, 1, 1, 2, -1, -1, -1])
    with torch.profiler.profile(activities=CPU):
        assert live_slots(gid, 2, 2) == 4
        require_consecutive_runs(receivers, 3, "test")
        for _ in range(3):  # the same layouts: cached, no read
            assert live_slots(gid, 2, 2) == 4
            require_consecutive_runs(receivers, 3, "test")
    rec = profiling.recorded()
    assert rec.counters == {"host_sync.live_slots": 1,
                            "host_sync.require_consecutive_runs": 1}
    assert rec.counted("host_sync") == 2
    with torch.profiler.profile(activities=CPU):
        live_slots(gid, 2, 2)
        gid[0] = 0  # written in place: a new version of the layout
        live_slots(gid, 2, 2)
        live_slots(gid.clone(), 2, 2)  # a new layout tensor
    assert profiling.recorded().counters == {"host_sync.live_slots": 2}


def trace_events(path):
    data = json.loads(path.read_text())
    return data, data["traceEvents"]


def test_trace_puts_spans_on_the_trace_clock(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)  # the host's operators
    a = torch.randn(64, 64)
    with profiling.trace(tmp_path) as prof:
        with profiling.span("matmul", request=3):
            torch.mm(a, a)
        profiling.count("host_sync.test")
    assert any(e.key == "aten::mm" for e in prof.key_averages())
    data, events = trace_events(tmp_path / "trace.json")
    assert int(data["baseTimeNanoseconds"]) == profiling.recorded().base_ns
    mm = next(e for e in events if e.get("name") == "aten::mm")
    span = next(e for e in events if e.get("cat") == "program" and e["ph"] == "X")
    assert span["name"] == "matmul" and span["args"]["request"] == 3
    assert span["tid"] == mm["tid"] and span["pid"] == mm["pid"]
    assert span["ts"] <= mm["ts"] and mm["ts"] + mm["dur"] <= span["ts"] + span["dur"]
    counter = next(e for e in events if e.get("cat") == "program" and e["ph"] == "C")
    assert counter["args"] == {"host_sync.test": 1}


def test_trace_events_convert_each_stamp():
    span = profiling.Span("s", 5_000_000, 7_500_000, 11, 4, 2, {"step": 0}, device_ms=1.5)
    rec = profiling.Recording(spans=[span], counters={"c": 3}, base_ns=1_000_000)
    assert profiling.trace_us(5_000_000, 1_000_000) == 4000.0
    x, c = profiling.trace_events(rec, 1_000_000, pid=9)
    assert x == {"ph": "X", "cat": "program", "name": "s", "pid": 9, "tid": 11, "ts": 4000.0,
                 "dur": 2500.0, "args": {"step": 0, "id": 4, "parent": 2, "device_ms": 1.5}}
    assert c == {"ph": "C", "cat": "program", "name": "program counters", "pid": 9,
                 "ts": 6500.0, "args": {"c": 3}}


def test_card_span_encloses_its_launch(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.cuda.synchronize()
    with profiling.trace(tmp_path) as prof:
        with profiling.span("sleep", device=True):
            torch.cuda._sleep(1_000_000)
    assert prof is not None
    data, events = trace_events(tmp_path / "trace.json")
    rec = profiling.recorded()
    assert int(data["baseTimeNanoseconds"]) == rec.base_ns
    (sleep,) = rec.named("sleep")
    assert sleep.device_ms > 0.1  # a million cycles
    span = next(e for e in events if e.get("cat") == "program" and e["name"] == "sleep")
    kernel = next(e for e in events if e.get("cat") == "kernel" and "spin" in e["name"])
    launch = next(e for e in events if e.get("cat") == "cuda_runtime"
                  and e.get("args", {}).get("correlation") == kernel["args"]["correlation"])
    assert launch["name"].startswith("cudaLaunchKernel")
    assert span["ts"] <= launch["ts"] and launch["ts"] + launch["dur"] <= span["ts"] + span["dur"]
    assert not [e for e in events if e.get("cat") == "kernel" and "spin" not in e["name"]]
