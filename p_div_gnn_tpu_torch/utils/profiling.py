"""Tracing and timing helpers: the counterpart of
``p_div_gnn_tpu/utils/profiling.py`` over ``torch.profiler``.

- ``trace(log_dir)``: a ``torch.profiler`` trace (CPU, and the card's
  kernels when CUDA is available) written as ``trace.json`` (Chrome /
  Perfetto format) under ``log_dir``; the context yields the profiler,
  whose ``key_averages()`` splits host and device time.
- ``timeit``: the wall time of ``fn(*args)``, bracketed by
  ``torch.cuda.synchronize()`` when the card is in use, after warm-up calls.
- ``compiled_stats``: the FLOPs of one call, counted by
  ``torch.utils.flop_counter.FlopCounterMode``; ``bytes_accessed`` is
  ``-1.0``, as the JAX function reports when XLA gives no figure.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Any, Callable, Iterator

import torch

DEFAULT_TRACE_DIR = Path(__file__).resolve().parents[2] / "build" / "pdg_trace"


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str | Path = DEFAULT_TRACE_DIR) -> Iterator[torch.profiler.profile]:
    """Profile the block; writes ``<log_dir>/trace.json`` at its end."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(str(log_dir / "trace.json"))


def timeit(
    fn: Callable[..., Any],
    *args: Any,
    iters: int = 20,
    warmup: int = 1,
    **kwargs: Any,
) -> dict[str, float]:
    """Synced wall time of ``fn(*args, **kwargs)``: ``warmup`` calls first,
    then ``iters`` calls between two synchronizations."""
    for _ in range(warmup):
        fn(*args, **kwargs)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args, **kwargs)
    _sync()
    total = time.perf_counter() - t0
    return {"mean_s": total / iters, "total_s": total, "iters": iters}


def compiled_stats(fn: Callable[..., Any], *args: Any) -> dict[str, float]:
    """FLOPs of one call of ``fn(*args)`` (FlopCounterMode's count: 2·m·k·n
    a matmul); ``bytes_accessed`` is not counted (-1.0)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return {"flops": float(counter.get_total_flops()), "bytes_accessed": -1.0}
