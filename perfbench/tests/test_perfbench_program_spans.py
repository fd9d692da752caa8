"""The readers of the program's own spans and counters
(``harness/program.py``, ``metrics/step.*_ms.train.py``,
``loader.wait_ms.train.py``, ``step.host_syncs.train.py``) on a synthetic
run and a hand-made record, against hand counts; each reads None where the
program recorded nothing."""

import pytest

from perfbench.harness import registry
from perfbench.harness.trace import Trace, merge
from perfbench.harness.yardstick import Run
from p_div_gnn_tpu_torch.utils import profiling

READERS = ["step.forward_ms.train", "step.backward_ms.train", "step.optimizer_ms.train",
           "step.host_code_idle_ms.train", "loader.wait_ms.train", "step.host_syncs.train"]
BASE = 10**18  # the trace's base, ns
CFG = {"latent_size": 4, "message_passing_steps": 2, "stream_dtype": "float32"}


def at(us: float) -> int:
    """The stamp that ``trace_us`` puts at ``us``."""
    return BASE + int(us * 1000)


def record() -> profiling.Recording:
    spans = []

    def add(name, t0, t1, parent=None, device_ms=None, **attrs):
        spans.append(profiling.Span(name, at(t0), at(t1), 1, len(spans), parent, attrs,
                                    device_ms=device_ms))
        return len(spans) - 1

    add("loader.wait", 1.0, 201.0)  # 0.2 ms
    s0 = add("step", 5.0, 55.0, step=0)
    add("step.forward", 5.0, 25.0, s0, device_ms=30.0)
    add("step.backward", 25.0, 50.0, s0, device_ms=140.0)
    add("step.optimizer", 50.0, 55.0, s0, device_ms=1.0)
    add("loader.wait", 56.0, 456.0)  # 0.4 ms
    s1 = add("step", 58.0, 95.0, step=1)
    add("step.forward", 58.0, 70.0, s1, device_ms=32.0)
    add("step.backward", 70.0, 92.0, s1, device_ms=150.0)
    add("step.optimizer", 92.0, 95.0, s1, device_ms=1.0)
    add("serve.forward", 96.0, 97.0, device_ms=9.0)
    counters = {"host_sync.live_slots": 2, "host_sync.require_consecutive_runs": 4, "other": 9}
    return profiling.Recording(spans=spans, counters=counters, base_ns=BASE)


def run(unit: str = "step") -> Run:
    """Kernels at 2-10, 20-30, 50-60 and 90-100 us: idle gaps 0-2 (before
    any step), 10-20 (in step 0's forward), 30-50 (a runtime call under way
    at 30) and 60-90 (in step 1's forward)."""
    dev = [("k", "kernel", 2.0, 8.0), ("k", "kernel", 20.0, 10.0), ("k", "kernel", 50.0, 10.0),
           ("k", "kernel", 90.0, 10.0)]
    host = [("cudaLaunchKernel", "cuda_runtime", 28.0, 7.0), ("train_step", "span", 0.0, 96.0)]
    trace = Trace(device=dev, host=host, start_us=0.0, end_us=100.0)
    trace.merged = merge([(s, s + d) for _, _, s, d in dev])
    return Run(cfg=CFG, unit=unit, units=[{"E": 10, "N": 5}] * 2, trace=trace, kernels={})


WANT = {"step.forward_ms.train": 31.0, "step.backward_ms.train": 145.0,
        "step.optimizer_ms.train": 1.0,
        "step.host_code_idle_ms.train": (10.0 + 30.0) / 1e3 / 2,
        "loader.wait_ms.train": (0.2 + 0.4) / 2, "step.host_syncs.train": 3.0}


@pytest.mark.parametrize("name", READERS)
def test_reader_hand_count(name, monkeypatch):
    monkeypatch.setattr(profiling, "recorded", record)
    assert registry.metric_reader(name).read(run()) == pytest.approx(WANT[name])


def test_no_syncs_read_zero(monkeypatch):
    rec = record()
    rec.counters = {}
    monkeypatch.setattr(profiling, "recorded", lambda: rec)
    assert registry.metric_reader("step.host_syncs.train").read(run()) == 0.0


@pytest.mark.parametrize("name", READERS)
def test_reader_finds_nothing(name, monkeypatch):
    reader = registry.metric_reader(name)
    monkeypatch.setattr(profiling, "recorded", record)
    assert reader.read(run("request")) is None  # a serving run
    no_steps = record()
    no_steps.spans = [s for s in no_steps.spans if not s.name.startswith("step")]
    monkeypatch.setattr(profiling, "recorded", lambda: no_steps)
    assert reader.read(run()) is None
    monkeypatch.setattr(profiling, "recorded", profiling.Recording)
    assert reader.read(run()) is None
    monkeypatch.delattr(profiling, "recorded")  # a program without the recorder
    assert reader.read(run()) is None


def test_the_benchmark_lists_the_readers():
    entries = {m["name"]: m for m in registry.benchmark()["per_layer"]}
    for name in READERS:
        assert entries[name]["workloads"] == ["train.fp32"]
        assert entries[name]["moves"] == "train_edges_per_s"
