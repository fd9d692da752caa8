"""ctypes bindings for the native host graph library
(``p_div_gnn_tpu_torch/csrc/graphcore.cpp``), the counterpart of
``p_div_gnn_tpu/graphs/native.py``.

g++ builds the library at first use with the JAX package's flags into
``build/p_div_gnn_tpu_torch/`` at the checkout's root, named by a hash of
the source and the flags (as ``ops/cuda_build.py`` names the CUDA
libraries), under a temporary name renamed into place, so concurrent first
uses do not clash. Every entry point returns None when the library is
unavailable (no g++, a failed build, or ``PDG_NO_NATIVE`` set), and the
callers in ``graphs/build.py``, ``labels.py`` and ``periodic.py`` then take
their numpy paths, which stay the behavioral reference.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "graphcore.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "p_div_gnn_tpu_torch"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_LIB: ctypes.CDLL | None = None
_TRIED = False
build_seconds = 0.0  # g++'s time in this process; 0.0 when a built library was loaded
build_error = ""  # why the library is unavailable, when it is


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"graphcore-{h.hexdigest()[:16]}.so"


def _build() -> Path:
    """Build the library if it is not there; raises on a failed build."""
    global build_seconds
    out = library_path()
    if not out.is_file():
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        build_seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed on {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL | None:
    global _LIB, _TRIED, build_error
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("PDG_NO_NATIVE"):
        build_error = "PDG_NO_NATIVE is set"
        return None
    try:
        lib = ctypes.CDLL(str(_build()))
    except (OSError, RuntimeError) as exc:
        build_error = str(exc)
        return None
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i64 = ctypes.c_int64
    lib.pdg_faces_to_edges.restype = i64
    lib.pdg_faces_to_edges.argtypes = [i64p, i64, i64, i64, i64p, i64p]
    lib.pdg_label_nodes.restype = i64
    lib.pdg_label_nodes.argtypes = [i64p, i64, i64, i64, f64p, i64p]
    lib.pdg_periodic_pairs.restype = i64
    lib.pdg_periodic_pairs.argtypes = [f64p, i64, i64p, i64p]
    _LIB = lib
    return _LIB


def available() -> bool:
    """Whether the native library is built and loaded (False under
    ``PDG_NO_NATIVE``)."""
    return _load() is not None


@contextlib.contextmanager
def disabled():
    """Inside the block every entry point returns None, so the callers take
    their numpy paths; the library stays loaded for after it."""
    global _LIB, _TRIED
    saved = _LIB, _TRIED
    _LIB, _TRIED = None, True
    try:
        yield
    finally:
        _LIB, _TRIED = saved


def faces_to_edge_index(faces: np.ndarray, num_nodes: int) -> np.ndarray | None:
    """The (2, E) symmetrized, deduplicated edge index sorted by (sender,
    receiver); None without the library."""
    lib = _load()
    if lib is None:
        return None
    faces = np.ascontiguousarray(faces, np.int64)
    n_faces, arity = faces.shape
    cap = 2 * arity * n_faces
    snd = np.empty(cap, np.int64)
    rcv = np.empty(cap, np.int64)
    m = lib.pdg_faces_to_edges(faces, n_faces, arity, num_nodes, snd, rcv)
    return np.stack([snd[:m], rcv[:m]])


def compute_node_labels(faces: np.ndarray, points2d: np.ndarray) -> np.ndarray | None:
    """Node labels (``graphs/labels.py::NodeType``); raises ValueError
    unless the mesh has exactly two boundary regions, as the numpy path
    does; None without the library."""
    lib = _load()
    if lib is None:
        return None
    faces = np.ascontiguousarray(faces, np.int64)
    pts = np.ascontiguousarray(points2d, np.float64)
    n = len(pts)
    labels = np.empty(n, np.int64)
    n_regions = lib.pdg_label_nodes(faces, faces.shape[0], faces.shape[1], n, pts, labels)
    if n_regions != 2:
        raise ValueError(f"Expected 2 regions, found {n_regions} for the given mesh")
    return labels


def periodic_pairs(points2d: np.ndarray) -> tuple[np.ndarray, np.ndarray] | None:
    """(extra senders, extra receivers) of the periodic boundary links;
    raises ValueError on a mesh that is not periodic; None without the
    library."""
    lib = _load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points2d, np.float64)
    n = len(pts)
    cap = 4 * n + 8
    snd = np.empty(cap, np.int64)
    rcv = np.empty(cap, np.int64)
    k = lib.pdg_periodic_pairs(pts, n, snd, rcv)
    if k < 0:
        raise ValueError("opposite boundary node counts differ or a corner node is missing: "
                         "mesh is not periodic")
    return snd[:k], rcv[:k]
