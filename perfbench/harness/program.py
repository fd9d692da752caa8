"""The program's own spans and counters of a traced window, as the port's
recorder (``p_div_gnn_tpu_torch/utils/profiling.py``) kept them while the
window's profiler session was open: the training step's phases with their
device time, the loader's waits, the host syncs of the layout checks.

A program without that recorder, or a window in which it recorded no
training step, gives None, and so does every metric read from it.
"""

from __future__ import annotations

import bisect

from perfbench.harness.trace import idle_gaps, merge

STEP = "step"  # the program's span around one Trainer.train_step


def recording():
    """The recorder's record of the latest profiler session, or None."""
    from p_div_gnn_tpu_torch.utils import profiling

    recorded = getattr(profiling, "recorded", None)
    if recorded is None:
        return None
    rec = recorded()
    return rec if rec.named(STEP) else None


def _window(run):
    """(the record, its step count) of a training run's window, or None."""
    rec = recording() if run.unit == "step" else None
    return None if rec is None else (rec, len(rec.named(STEP)))


def phase_ms(run, name: str) -> float | None:
    """Device ms a step between the edges of the program's ``name`` spans."""
    window = _window(run)
    if window is None:
        return None
    ms = [s.device_ms for s in window[0].named(name) if s.device_ms is not None]
    return sum(ms) / window[1] if ms else None


def host_ms(run, name: str) -> float | None:
    """Host ms a step inside the program's ``name`` spans."""
    window = _window(run)
    return None if window is None else sum(s.ms for s in window[0].named(name)) / window[1]


def counted(run, prefix: str) -> float | None:
    """The counter ``prefix`` (with its sites) a step."""
    window = _window(run)
    return None if window is None else window[0].counted(prefix) / window[1]


def _covers(intervals: list[tuple[float, float]], at: float) -> bool:
    """Whether ``at`` lies in one of the disjoint sorted ``intervals``
    (start included, end not)."""
    i = bisect.bisect_right(intervals, (at, float("inf"))) - 1
    return i >= 0 and intervals[i][0] <= at < intervals[i][1]


def host_code_idle_ms(run) -> float | None:
    """Device idle ms a step in the gaps that began while a program span
    of the training step (``step``, ``step.*``) was open and no CUDA runtime
    call was under way: idle time put down to the step's own host code."""
    window = _window(run)
    if window is None:
        return None
    rec, steps = window
    from p_div_gnn_tpu_torch.utils.profiling import trace_us

    spans = merge([(trace_us(s.start_ns, rec.base_ns), trace_us(s.end_ns, rec.base_ns))
                   for s in rec.spans if s.name == STEP or s.name.startswith(STEP + ".")])
    calls = merge([(t, t + d) for _, cat, t, d in run.trace.host if cat == "cuda_runtime"])
    idle_us = sum(hi - lo for lo, hi in idle_gaps(run.trace)
                  if _covers(spans, lo) and not _covers(calls, lo))
    return idle_us / 1e3 / steps
