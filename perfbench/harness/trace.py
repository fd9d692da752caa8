"""The device trace of a run's traced window, reduced to what the
per-layer metrics read: the device intervals with their names, the window,
the busy time (the union of every kernel, copy and set interval) and what
the host was doing in each idle gap.

The profiler records CUDA activity only (kernels, copies, sets and the
CUDA runtime calls): recording every host operation as well slows the
host enough to double the device's idle time. The host's side comes from
the benchmark's own spans around its calls into the program (``Spans``),
placed on the trace's clock by a marker kernel launched at a known time.
The trace is written to ``TMPDIR``, read back and deleted.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path

import torch

from perfbench.harness.common import sync

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "spin_kernel"  # torch.cuda._sleep's kernel


@dataclass
class Trace:
    device: list[tuple[str, str, float, float]]  # (name, cat, start us, duration us)
    host: list[tuple[str, str, float, float]]  # spans and CUDA runtime calls, same clock
    start_us: float
    end_us: float
    merged: list[tuple[float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(hi - lo for lo, hi in self.merged) / 1e6

    def kernels(self) -> list[tuple[str, float]]:
        """(name, seconds) of every kernel launch in the window."""
        return [(n, d / 1e6) for n, c, _, d in self.device if c == "kernel"]


class Spans:
    """The benchmark's host spans around calls into the program, from any
    thread: ``with spans("pack_batch"): ...``."""

    def __init__(self) -> None:
        self.log: list[tuple[str, float, float]] = []  # (name, start s, end s)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            with self._lock:
                self.log.append((name, t0, time.perf_counter()))

    def durations(self) -> dict[str, list[float]]:
        out: dict[str, list[float]] = defaultdict(list)
        for name, t0, t1 in self.log:
            out[name].append(t1 - t0)
        return dict(out)


@contextlib.contextmanager
def traced(out: dict, spans: Spans, device: str = "cuda"):
    """Profile the block; ``out["trace"]`` is the window's ``Trace`` after
    it. The block's work is synchronised before the profiler stops."""
    cuda = torch.device(device).type == "cuda"
    acts = [torch.profiler.ProfilerActivity.CUDA if cuda else torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        if cuda:
            torch.cuda._sleep(1000)
        yield
        sync(device)
        t1 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="perfbench-trace-") as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
        os.remove(path)
    out["trace"] = reduce_events(events, t0, t1, spans.log)


def reduce_events(events: list[dict], t0: float, t1: float,
                  spans: list[tuple[str, float, float]]) -> Trace:
    """The window from ``t0`` to ``t1`` (host seconds) on the trace's clock:
    the marker kernel's launch call was made at ``t0``."""
    device = [(e["name"], e["cat"], float(e["ts"]), float(e["dur"])) for e in events
              if e.get("cat") in DEVICE_CATS and "dur" in e]
    runtime = [e for e in events if e.get("cat") == "cuda_runtime" and "dur" in e]
    marker = next((e for e in events if e.get("cat") == "kernel" and MARKER in e["name"]), None)
    launch = None
    if marker is not None:
        corr = marker.get("args", {}).get("correlation")
        launch = next((float(e["ts"]) for e in runtime
                       if e.get("args", {}).get("correlation") == corr), None)
    if launch is None:  # no marker: the window starts at its first device interval
        launch = min([t for _, _, t, _ in device], default=t0 * 1e6)
    offset = launch - t0 * 1e6
    device = [d for d in device if MARKER not in d[0]]
    host = [(e["name"], "cuda_runtime", float(e["ts"]), float(e["dur"])) for e in runtime]
    host += [(n, "span", s * 1e6 + offset, (e - s) * 1e6) for n, s, e in spans]
    start = t0 * 1e6 + offset
    end = max([t1 * 1e6 + offset] + [t + d for _, _, t, d in device])
    trace = Trace(device=device, host=host, start_us=start, end_us=end)
    trace.merged = merge([(t, t + d) for _, _, t, d in device])
    return trace


def merge(spans: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """The union of intervals, as disjoint sorted intervals."""
    out: list[list[float]] = []
    for lo, hi in sorted(spans):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def idle_gaps(trace: Trace) -> list[tuple[float, float]]:
    """The window's intervals in which the device ran nothing."""
    gaps, at = [], trace.start_us
    for lo, hi in trace.merged:
        if lo > at:
            gaps.append((at, lo))
        at = max(at, hi)
    if trace.end_us > at:
        gaps.append((at, trace.end_us))
    return gaps


def gap_labels(trace: Trace) -> dict[str, float]:
    """Idle seconds by what the host was doing when each gap began: the
    benchmark's innermost span there (the latest begun), and the CUDA
    runtime call under way then, or "host code" where none was."""
    host = sorted(trace.host, key=lambda e: e[2])
    totals: dict[str, float] = defaultdict(float)
    active: list[tuple[str, str, float, float]] = []
    i = 0
    for lo, hi in idle_gaps(trace):
        while i < len(host) and host[i][2] <= lo:
            active.append(host[i])
            i += 1
        active = [e for e in active if e[2] + e[3] > lo]
        spans = [e for e in active if e[1] == "span"]
        calls = [e for e in active if e[1] == "cuda_runtime"]
        outer = max(spans, key=lambda e: e[2])[0] if spans else "no span"
        inner = max(calls, key=lambda e: e[2])[0] if calls else "host code"
        totals[f"{outer} / {inner}"] += (hi - lo) / 1e6
    return totals


def breakdown(trace: Trace) -> dict[str, list]:
    """The ten device operations that took most time (summed by name) and
    the ten host activities under which the device idled longest."""
    by_name: dict[str, float] = defaultdict(float)
    for name, _, _, dur in trace.device:
        by_name[name[:160]] += dur / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(gap_labels(trace).items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n[:160], s] for n, s in gaps]}
