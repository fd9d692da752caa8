"""The seam between the port's Python and its CUDA sources: how a kernel
source of ``csrc/`` becomes a callable, and how a wrapper launches it.

Build. Each source exposes a plain ``extern "C"`` interface (raw pointers,
sizes, the ``cudaStream_t``) and includes no PyTorch header, so nvcc builds
it in seconds. The shared library goes to ``build/p_div_gnn_tpu_torch/`` at
the checkout's root, named by a hash of the source, the ``csrc/`` headers it
includes, the flags and the build's ``-D`` defines, so an edited source or
header is rebuilt and an unchanged one is loaded as it is. The library is
compiled under a temporary name and renamed into place: a run that is cut
off leaves no half-built library behind and no lock to wait on.

Bind. The C source is the only statement of a library's ABI: at load, every
``pdg_*`` function defined in the source and its local headers gets its
ctypes ``argtypes`` and ``restype`` from its C definition (``int``,
``int64_t``, any pointer, a returned ``const char*``); any other C type
raises, naming the function. A definition the build leaves out (one under
an ``#if``) is skipped.

Load and swap. ``library(name, defines)`` is each library, loaded once per
process. ``using(loader)`` makes every wrapper's library come from another
loader inside a ``with`` block: the CPU emulation's g++ build, a timing
variant built with other defines, or a stub that raises.

Launch and count. ``launch(kernel, entry, *args)`` calls the entry point
``entry`` (``pdg_<name>...``, defined in ``csrc/<name>.cu``) with the
tensors as device pointers on their device's current stream, raises on an
error code, and adds one to ``launches[kernel]``. This count is kept apart
from ``utils/profiling.count``: tests and ``chip_smoke.py`` read it with no
profiler session open, where ``count`` records nothing.

A new kernel is a ``csrc/<name>.cu`` with an ``extern "C"`` launch function
``pdg_<name>`` that takes the stream last and returns a ``cudaError_t``,
plus ``pdg_cuda_error_string``, and a wrapper that checks its inputs,
allocates its outputs and calls ``launch``.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Iterator

import torch

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "p_div_gnn_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# launches of each kernel's entry points in this process, by kernel name
launches: collections.Counter = collections.Counter()


@dataclasses.dataclass
class CudaLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an earlier build was loaded
    build_log: str  # nvcc's output, with ptxas' registers / spills per kernel


def find_nvcc() -> str | None:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    return str(candidate) if candidate.is_file() else None


def local_headers(source: Path) -> list[Path]:
    """The ``csrc/`` headers a source includes with ``#include "..."``."""
    names = re.findall(r'^\s*#\s*include\s*"([^"]+)"', source.read_text(), flags=re.M)
    return [CSRC_DIR / n for n in names]


def _define_flags(defines: tuple[str, ...]) -> tuple[str, ...]:
    return tuple(f"-D{d}" for d in defines)


def library_path(name: str, defines: tuple[str, ...] = ()) -> Path:
    """Where the build of ``csrc/<name>.cu`` goes: named by a hash of the
    source, its ``csrc/`` headers, the flags and the defines."""
    source = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256(source.read_bytes())
    for header in local_headers(source):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS + _define_flags(defines)).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


_RETURNS = {"int": ctypes.c_int, "int64_t": ctypes.c_int64, "void": None,
            "const char*": ctypes.c_char_p}
_PARAMS = {"int": ctypes.c_int, "int64_t": ctypes.c_int64}
_DEFINITION = re.compile(
    r'^[ \t]*(?:extern\s+"C"\s+)?((?:const\s+)?\w+(?:\s*\*)*)\s*\b(pdg_\w+)\s*\(([^)]*)\)\s*\{',
    flags=re.M)


def _param_type(fn: str, param: str):
    if "*" in param:
        return ctypes.c_void_p
    words = param.split()
    c_type = " ".join(w for w in (words[:-1] if len(words) > 1 else words) if w != "const")
    if c_type not in _PARAMS:
        raise ValueError(f"{fn}: C parameter type {c_type!r} has no ctypes binding")
    return _PARAMS[c_type]


def signatures(name: str) -> dict[str, tuple[list, object]]:
    """(argtypes, restype) of every ``pdg_*`` function that ``csrc/<name>.cu``
    and its local headers define, read from the C definitions."""
    source = CSRC_DIR / f"{name}.cu"
    found = {}
    for path in [source, *local_headers(source)]:
        text = re.sub(r"//[^\n]*|/\*.*?\*/", "", path.read_text(), flags=re.S)
        for ret, fn, params in _DEFINITION.findall(text):
            ret = re.sub(r"\s*\*", "*", ret.strip())
            if ret not in _RETURNS:
                raise ValueError(f"{fn}: C return type {ret!r} has no ctypes binding")
            args = [p.strip() for p in params.split(",")]
            args = [] if args in ([""], ["void"]) else args
            found[fn] = ([_param_type(fn, p) for p in args], _RETURNS[ret])
    return found


def open_library(path: Path, name: str, build_seconds: float = 0.0,
                 build_log: str = "") -> CudaLibrary:
    """Load a build of ``csrc/<name>.cu`` and bind its entry points from
    the source (``signatures``); one the build left out is skipped."""
    lib = ctypes.CDLL(str(path))
    for fn, (argtypes, restype) in signatures(name).items():
        try:
            f = getattr(lib, fn)
        except AttributeError:
            continue
        f.argtypes, f.restype = argtypes, restype
    return CudaLibrary(lib, path, build_seconds, build_log)


def load_cuda_library(name: str, defines: tuple[str, ...] = ()) -> CudaLibrary:
    """Build (if needed) and load ``csrc/<name>.cu`` with ``-D`` each of
    ``defines``; raises RuntimeError when nvcc is missing or the build
    fails. Every source exports ``pdg_cuda_error_string``, which
    ``check_launch`` reads."""
    source = CSRC_DIR / f"{name}.cu"
    out = library_path(name, defines)
    seconds, log = 0.0, ""
    if not out.is_file():
        nvcc = find_nvcc()
        if nvcc is None:
            raise RuntimeError(
                f"cannot build {source.name}: nvcc not found (PATH, CUDA_HOME, "
                "/usr/local/cuda)"
            )
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, *_define_flags(defines), "-o", str(tmp), str(source)],
            capture_output=True, text=True,
        )
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {source.name}:\n{log}")
        os.replace(tmp, out)
    return open_library(out, name, seconds, log)


Loader = Callable[[str, tuple[str, ...]], CudaLibrary]
_loader: Loader = load_cuda_library
_libraries: dict[tuple[str, tuple[str, ...]], CudaLibrary] = {}


def library(name: str, defines: tuple[str, ...] = ()) -> CudaLibrary:
    """``csrc/<name>.cu`` built with ``defines``, loaded once per process by
    the current loader (``load_cuda_library`` unless ``using`` says
    otherwise)."""
    key = (name, tuple(defines))
    built = _libraries.get(key)
    if built is None:
        built = _libraries[key] = _loader(*key)
    return built


def libraries(*keys: str | tuple[str, tuple[str, ...]]) -> list[CudaLibrary]:
    """``library`` of each key (a source name, or a (name, defines) pair),
    loaded in parallel: one nvcc a build."""
    pairs = [(k, ()) if isinstance(k, str) else k for k in keys]
    with ThreadPoolExecutor(max(1, len(pairs))) as pool:
        return list(pool.map(lambda k: library(*k), pairs))


@contextlib.contextmanager
def using(loader: Loader) -> Iterator[None]:
    """Inside the block every library comes from ``loader(name, defines)``;
    the loaded libraries are forgotten on entry and on exit."""
    global _loader
    saved = _loader
    _loader = loader
    _libraries.clear()
    try:
        yield
    finally:
        _loader = saved
        _libraries.clear()


def check_launch(built: CudaLibrary, err: int, kernel: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        msg = built.lib.pdg_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed: {msg} ({err})")


@functools.cache
def source_of(entry: str) -> str:
    """The source that defines an entry point ``pdg_<name>[_<suffix>]``:
    ``csrc/<name>.cu`` for the longest such name."""
    names = [p.stem for p in CSRC_DIR.glob("*.cu") if entry.startswith(f"pdg_{p.stem}")]
    if not names:
        raise ValueError(f"{entry}: no csrc/<name>.cu for an entry point pdg_<name>...")
    return max(names, key=len)


def launch(kernel: str, entry: str, *args, device: torch.device | None = None) -> None:
    """Call the entry point ``entry`` with ``args`` (tensors as their device
    pointers; None a null pointer; ints and ctypes objects as they are) and
    the current stream of ``device`` (default: the first tensor's), on that
    device; raise on the error code it returns; count one launch of
    ``kernel``."""
    built = library(source_of(entry))
    if device is None:
        for a in args:
            if isinstance(a, torch.Tensor):
                device = a.device
                break
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        err = getattr(built.lib, entry)(*c_args, torch.cuda.current_stream(device).cuda_stream)
    if err:
        check_launch(built, err, entry)
    launches[kernel] += 1


def device_kind(who: str, *tensors) -> str:
    """"cuda" or "cpu": where a wrapper's call runs, from its tensors' device
    type (a kernel or the plain version); raises on anything else or a
    mix."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"} or kinds == {"cpu"}:
        return kinds.pop()
    raise ValueError(f"{who} runs on cuda or cpu tensors, got {sorted(kinds)}")
