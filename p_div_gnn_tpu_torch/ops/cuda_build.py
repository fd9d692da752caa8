"""Build a kernel source of ``csrc/`` with nvcc at first use, load it with
ctypes.

Each source exposes a plain ``extern "C"`` interface (raw pointers, sizes,
the ``cudaStream_t``) and includes no PyTorch header, so nvcc builds it in
seconds. The shared library goes to ``build/p_div_gnn_tpu_torch/`` at the
checkout's root, named by a hash of the source, the ``csrc/`` headers it
includes and the flags, so an edited source or header is rebuilt and an
unchanged one is loaded as it is. The library is
compiled under a temporary name and renamed into place: a run that is cut
off leaves no half-built library behind and no lock to wait on.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "p_div_gnn_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


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


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` goes: named by a hash of the
    source, its ``csrc/`` headers and the flags."""
    source = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256(source.read_bytes())
    for header in local_headers(source):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def load_cuda_library(name: str) -> CudaLibrary:
    """Build (if needed) and load ``csrc/<name>.cu``; raises RuntimeError when
    nvcc is missing or the build fails. Every source exports
    ``pdg_cuda_error_string``, which ``check_launch`` reads."""
    source = CSRC_DIR / f"{name}.cu"
    out = library_path(name)
    seconds, log = 0.0, ""
    if not out.is_file():
        nvcc = find_nvcc()
        if nvcc is None:
            raise RuntimeError(
                f"cannot build {source.name}: nvcc not found (PATH, CUDA_HOME, "
                "/usr/local/cuda)"
            )
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)],
            capture_output=True, text=True,
        )
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {source.name}:\n{log}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.pdg_cuda_error_string.argtypes = [ctypes.c_int]
    lib.pdg_cuda_error_string.restype = ctypes.c_char_p
    return CudaLibrary(lib, out, seconds, log)


def check_launch(built: CudaLibrary, err: int, kernel: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        msg = built.lib.pdg_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed: {msg} ({err})")
