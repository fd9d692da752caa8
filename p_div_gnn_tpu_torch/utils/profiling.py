"""The port's tracing: spans and counters recorded inside the program while
a ``torch.profiler`` session is open, and ``trace()``, which shows them
above the device's kernels in one Perfetto view.

- ``span(name, device=False, **attrs)``: a context manager around one phase
  of the work (a training step's forward, a served request's packing). It
  records the name, start, end, thread, enclosing span and attributes
  (such as a step or request id). With ``device=True`` it also records a
  CUDA event on the current stream at each edge, so the span carries the
  device ms between them (``Span.device_ms``). ``.set(**attrs)`` adds
  attributes known only inside the span.
- ``count(name, n=1)``: adds to a counter.
- ``recorded()``: the spans and counters of the latest recording session.
- ``trace(log_dir)``: a profiler session over the block, written as
  ``<log_dir>/trace.json`` with the program's spans in it.

The recorder is on exactly while a profiler session is open: torch sets
``torch.autograd.profiler._is_profiler_enabled`` at every profiler start
and clears it at the stop, and every start begins a new record. Off,
``span`` returns one shared no-op context and ``count`` returns at once:
one flag check, no clock read, no CUDA call. Spans stay in memory; CUDA
events are read by ``recorded()``, after the traced window.

A span is stamped with ``time.time_ns()``: the unix-epoch nanoseconds on
which Kineto stamps the profiler's events. The exported trace shows its
events in µs after its ``baseTimeNanoseconds``; ``trace_us`` is the one
conversion from a span's stamp to that clock, so a span and the trace's
operator, runtime-call and kernel events compare directly.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Iterator

import torch
import torch.autograd.profiler as _torch_profiler

DEFAULT_TRACE_DIR = Path(__file__).resolve().parents[2] / "build" / "pdg_trace"

# Kineto's trace base: unix time floored to whole intervals of this many
# seconds (about three months), in nanoseconds
_BASE_INTERVAL_S = 7_889_238


def trace_base_ns(unix_s: float) -> int:
    """The ``baseTimeNanoseconds`` of a trace exported at ``unix_s``."""
    return int(unix_s) // _BASE_INTERVAL_S * _BASE_INTERVAL_S * 1_000_000_000


def trace_us(stamp_ns: int, base_ns: int) -> float:
    """A span's stamp on the exported trace's clock (its events' ``ts``)."""
    return (stamp_ns - base_ns) / 1e3


@dataclass
class Span:
    name: str
    start_ns: int
    end_ns: int
    thread: int  # the native thread id, as the trace's ``tid``
    id: int
    parent: int | None  # the id of the enclosing span on the same thread
    attrs: dict[str, Any]
    device_ms: float | None = None  # device time between the edges (``device=True``)
    _events: tuple | None = field(default=None, repr=False, compare=False)

    @property
    def ms(self) -> float:
        """Host ms between the edges."""
        return (self.end_ns - self.start_ns) / 1e6


@dataclass
class Recording:
    spans: list[Span] = field(default_factory=list)  # in order of their start
    counters: dict[str, int] = field(default_factory=dict)
    base_ns: int = 0  # the session's trace base (``trace_us``)

    def named(self, name: str) -> list[Span]:
        return [s for s in self.spans if s.name == name]

    def counted(self, prefix: str) -> int:
        """The sum of the counter ``prefix`` and of ``prefix.<site>``."""
        return sum(n for k, n in self.counters.items()
                   if k == prefix or k.startswith(prefix + "."))


class _Session:
    def __init__(self) -> None:
        self.spans: list[Span] = []
        self.counters: dict[str, int] = {}
        self.base_ns = trace_base_ns(time.time())
        self.lock = threading.Lock()


_session = _Session()
_ids = itertools.count()
_local = threading.local()


def _new_session(start=_torch_profiler._run_on_profiler_start) -> None:
    global _session
    _session = _Session()
    start()


# every profiler start (torch.profiler, the autograd profiler, emit_nvtx)
# calls this hook just before it sets the flag
_torch_profiler._run_on_profiler_start = _new_session


class _NoSpan:
    """The span while the recorder is off."""

    def __enter__(self) -> _NoSpan:
        return self

    def __exit__(self, *exc: object) -> None:
        return None

    def set(self, **attrs: Any) -> None:
        return None


_NO_SPAN = _NoSpan()


class _OpenSpan:
    __slots__ = ("session", "span", "device")

    def __init__(self, name: str, device: bool, attrs: dict[str, Any]) -> None:
        self.session = _session
        self.device = device and torch.cuda.is_available() and torch.cuda.is_initialized()
        self.span = Span(name, 0, 0, threading.get_native_id(), next(_ids), None, attrs)

    def set(self, **attrs: Any) -> None:
        self.span.attrs.update(attrs)

    def __enter__(self) -> _OpenSpan:
        stack = _local.__dict__.setdefault("stack", [])
        self.span.parent = stack[-1] if stack else None
        stack.append(self.span.id)
        if self.device:
            begin = torch.cuda.Event(enable_timing=True)
            begin.record()
            self.span._events = (begin,)
        self.span.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc: object) -> None:
        self.span.end_ns = time.time_ns()
        if self.device:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.span._events += (end,)
        _local.stack.pop()
        self.session.spans.append(self.span)


def span(name: str, device: bool = False, **attrs: Any) -> _OpenSpan | _NoSpan:
    """A span named ``name`` around the block while a profiler session is
    open; the shared no-op otherwise."""
    if not _torch_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _OpenSpan(name, device, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler session is open."""
    if not _torch_profiler._is_profiler_enabled:
        return
    session = _session
    with session.lock:
        session.counters[name] = session.counters.get(name, 0) + n


def recorded() -> Recording:
    """The spans and counters of the latest recording session. Reading a
    span's device ms waits for its end event."""
    session = _session
    spans = sorted(session.spans, key=lambda s: s.start_ns)
    for s in spans:
        if s._events is not None and len(s._events) == 2:
            begin, end = s._events
            end.synchronize()
            s.device_ms, s._events = begin.elapsed_time(end), None
    with session.lock:
        counters = dict(session.counters)
    return Recording(spans=spans, counters=counters, base_ns=session.base_ns)


def trace_events(rec: Recording, base_ns: int, pid: int) -> list[dict]:
    """The recording as Chrome-trace events on a trace of base ``base_ns``:
    one complete event a span, one counter event at the last span's end."""
    events = []
    for s in rec.spans:
        args = dict(s.attrs, id=s.id, parent=s.parent)
        if s.device_ms is not None:
            args["device_ms"] = s.device_ms
        events.append({"ph": "X", "cat": "program", "name": s.name, "pid": pid, "tid": s.thread,
                       "ts": trace_us(s.start_ns, base_ns), "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": args})
    if rec.counters:
        end = max((s.end_ns for s in rec.spans), default=base_ns)
        events.append({"ph": "C", "cat": "program", "name": "program counters", "pid": pid,
                       "ts": trace_us(end, base_ns), "args": dict(rec.counters)})
    return events


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str | Path = DEFAULT_TRACE_DIR) -> Iterator[torch.profiler.profile]:
    """Profile the block and write ``<log_dir>/trace.json``: the card's
    activity (kernels, copies, CUDA runtime calls) where there is a card,
    the host's operators otherwise, and the program's spans and counters
    of the block on the same clock. Yields the profiler, whose
    ``key_averages()`` sums the trace by name."""
    cuda = torch.cuda.is_available()
    activity = torch.profiler.ProfilerActivity.CUDA if cuda else torch.profiler.ProfilerActivity.CPU
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=[activity]) as prof:
        yield prof
        _sync()
    path = log_dir / "trace.json"
    prof.export_chrome_trace(str(path))
    data = json.loads(path.read_text())
    rec = recorded()
    data["traceEvents"].extend(
        trace_events(rec, int(data.get("baseTimeNanoseconds", rec.base_ns)), os.getpid()))
    path.write_text(json.dumps(data))
