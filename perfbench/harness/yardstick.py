"""The benchmark's arithmetic: the card's peaks, a launch's least time from
its shapes (``kernels/<kernel>.json``), the model's FLOPs (counted by its
architecture's module), and the shares the per-layer metrics report.
Nothing here reads the program.

Peaks of one H100 SXM (NVIDIA's data sheet, dense, at the 700 W limit):
67 TFLOP/s fp32 outside the tensor cores, 989 TFLOP/s bf16 on the tensor
cores, 3.35 TB/s of HBM. A share is stated against these; the card's
power limit is printed beside every run.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from perfbench.harness import registry

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
STREAM_BYTES = {"float32": 4, "bfloat16": 2}


@dataclass
class Run:
    """What a per-layer metric reads: the configuration, the traced
    units (each step or request with its real edges ``E``, real nodes ``N``
    and, for a training step, the batch's edge slots ``slots``), the trace,
    the benchmark's own spans around calls into the program (seconds by
    name), and the port kernels' descriptions."""

    cfg: dict
    unit: str  # "step" or "request"
    units: list[dict]
    trace: object
    kernels: dict[str, dict]
    spans: dict[str, list[float]] = field(default_factory=dict)


def evaluate(formula: str, **sizes: float) -> float:
    """A kernel file's formula over the launch's sizes (L, E, N, s)."""
    return float(eval(formula, {"__builtins__": {}}, sizes))  # noqa: S307


def least_time(spec: dict, unit: dict, cfg: dict) -> float:
    """Seconds one launch of the kernel needs at the peaks: the larger of
    its operations over the peak of its precision and its bytes over HBM's
    rate."""
    sd = cfg["stream_dtype"]
    sizes = dict(L=cfg["latent_size"], E=unit["E"], N=unit["N"], s=STREAM_BYTES[sd])
    peak = PEAK_FLOPS[sd if spec["peak"] == "stream" else "float32"]
    return max(evaluate(spec["flops"], **sizes) / peak,
               evaluate(spec["bytes"], **sizes) / HBM_BYTES_PER_S)


def kernel_launches(run: Run, name: str) -> tuple[int, float]:
    """(launches, device seconds) of a port kernel in the window: its own
    sub-kernels count the launches, and the sub-kernels it shares with
    other port kernels go to it when its own ran and theirs did not."""
    spec = run.kernels[name]
    own = [(n, s) for n, s in run.trace.kernels() if any(k in n for k in spec["own"])]
    if not own:
        return 0, 0.0
    others_ran = any(
        any(k in n for n, _ in run.trace.kernels() for k in other["own"])
        for key, other in run.kernels.items()
        if key != name and set(other.get("shared", [])) & set(spec.get("shared", [])))
    shared = [] if others_ran else [
        s for n, s in run.trace.kernels() if any(k in n for k in spec.get("shared", []))]
    launches = sum(1 for n, _ in own if any(k in n for k in spec["launch"]))
    return launches, sum(s for _, s in own) + sum(shared)


def roofline(run: Run, name: str) -> float | None:
    """% of the kernel's least time in its measured time, per launch: the
    mean least time of the window's launches over their mean device time."""
    launches, seconds = kernel_launches(run, name)
    if not launches or not run.units or seconds <= 0:
        return None
    per_unit = launches / len(run.units)
    need = sum(least_time(run.kernels[name], u, run.cfg) for u in run.units) * per_unit
    return 100.0 * need / seconds


def model_flops(cfg: dict, E: int, N: int) -> tuple[float, float]:
    """(edge-stream FLOPs, other FLOPs) of one forward pass over E real
    edges and N real nodes, as the configuration's architecture module
    (``arch/<arch>.py``) counts them."""
    return registry.arch(cfg["arch"]).model_flops(cfg, E, N)


def model_least_time(cfg: dict, unit: dict, backward: bool) -> float:
    """Seconds the model's FLOPs of one unit need at the peaks of their
    precisions; a training step adds twice the forward for the backward."""
    stream, other = model_flops(cfg, unit["E"], unit["N"])
    t = stream / PEAK_FLOPS[cfg["stream_dtype"]] + other / PEAK_FLOPS["float32"]
    return t * (3 if backward else 1)


def mfu(run: Run) -> float | None:
    if not run.units or run.trace.window_s <= 0:
        return None
    need = sum(model_least_time(run.cfg, u, run.unit == "step") for u in run.units)
    return 100.0 * need / run.trace.window_s


def idle_share(run: Run) -> float | None:
    if run.trace.window_s <= 0 or not run.trace.merged:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def rest_seconds(run: Run) -> float:
    """Device seconds in operations that are none of the port kernels'."""
    names = [k for spec in run.kernels.values() for k in spec["own"] + spec.get("shared", [])]
    return sum(d for n, _, _, d in run.trace.device if not any(k in n for k in names)) / 1e6
