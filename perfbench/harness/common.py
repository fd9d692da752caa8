"""What every run shares: its cache directories, the card it needs, the
check that no JAX module was loaded, and the result it prints."""

from __future__ import annotations

import json
import os
import subprocess
import sys

from perfbench.harness.registry import ROOT

# whole top-level module names that no run may load: JAX and the JAX package
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "p_div_gnn_tpu")
# the benchmark's caches: kernel caches and the built mesh pools
CACHE = ROOT / "build" / "perfbench"


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed place inside the checkout,
    before anything that reads the variables is imported. The port's CUDA
    and g++ libraries go to ``build/p_div_gnn_tpu_torch/`` by themselves."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(CACHE / sub)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def require_cards(count: int) -> None:
    """Exit without a result unless ``count`` CUDA cards are visible."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("perfbench: no CUDA card (torch.cuda.is_available() is False); "
                         "the benchmark has no CPU fallback")
    if torch.cuda.device_count() < count:
        raise SystemExit(f"perfbench: the cell needs {count} card(s), "
                         f"{torch.cuda.device_count()} visible")


def forbidden_loaded() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN_MODULES)


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


def emit(result: dict, checks: list[tuple[str, float, float]]) -> None:
    """The compared numbers beside their limits as the last lines on
    stderr, and the result as the last line on stdout with them last."""
    checks = [(n, v if v < 1e308 else 1e308, lim) for n, v, lim in checks]  # inf is no JSON
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr, flush=True)
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    print(json.dumps(result), flush=True)


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def peak_bytes(device) -> int:
    import torch

    return torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0


def reset_peak(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def say_setup(marks: list[tuple[str, float]]) -> None:
    """The set-up's phases on stderr, in seconds."""
    print("perfbench set-up: " + ", ".join(
        f"{name} {t - t_prev:.3f} s" for (_, t_prev), (name, t) in zip(marks, marks[1:])),
        file=sys.stderr, flush=True)
