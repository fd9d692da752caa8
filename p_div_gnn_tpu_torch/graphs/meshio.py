"""Standalone legacy-VTK mesh reader and writer, and the sample npz files
(numpy only).

Copy of ``p_div_gnn_tpu/graphs/meshio.py``: the legacy
``.vtk`` format in ASCII and big-endian binary, both the classic
``POLYGONS n size`` cell layout and the VTK>=5.1 ``OFFSETS``/
``CONNECTIVITY`` layout, so meshes produced by the reference tooling or the
JAX package's generator load without VTK.

Only single-element-type 2D surface meshes (triangles or quads) are
supported, matching the reference's own restriction
(`convert_utils.py:25` "Below functions works only with single
element-type meshes").
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np


@dataclasses.dataclass
class SurfaceMesh:
    """A single-element-type surface mesh.

    Attributes:
      points: (N, 3) float array of node coordinates.
      faces: (F, K) int array of cell connectivity (K=3 triangles, K=4 quads).
    """

    points: np.ndarray
    faces: np.ndarray

    @property
    def n_points(self) -> int:
        return int(self.points.shape[0])

    @property
    def n_cells(self) -> int:
        return int(self.faces.shape[0])

    def bounds2d(self) -> tuple[float, float, float, float]:
        pts = self.points[:, :2]
        (min_x, min_y), (max_x, max_y) = pts.min(0), pts.max(0)
        return float(min_x), float(max_x), float(min_y), float(max_y)


class _Tokens:
    """Sequential token/byte reader over a legacy VTK file."""

    def __init__(self, raw: bytes):
        self.raw = raw
        self.pos = 0

    def readline(self) -> str:
        end = self.raw.find(b"\n", self.pos)
        if end == -1:
            line = self.raw[self.pos :]
            self.pos = len(self.raw)
        else:
            line = self.raw[self.pos : end]
            self.pos = end + 1
        return line.decode("ascii", errors="replace").strip()

    def peekline(self) -> str:
        saved = self.pos
        line = self.readline()
        self.pos = saved
        return line

    def at_eof(self) -> bool:
        return self.pos >= len(self.raw)

    def read_binary_array(self, count: int, dtype: np.dtype) -> np.ndarray:
        itemsize = np.dtype(dtype).itemsize
        nbytes = count * itemsize
        arr = np.frombuffer(self.raw, dtype=dtype, count=count, offset=self.pos)
        self.pos += nbytes
        # Binary sections are terminated by a newline.
        if self.pos < len(self.raw) and self.raw[self.pos : self.pos + 1] == b"\n":
            self.pos += 1
        return arr

    def read_ascii_numbers(self, count: int, kind: str) -> np.ndarray:
        """Read `count` whitespace-separated numbers in ASCII mode."""
        vals: list[float] = []
        while len(vals) < count:
            line = self.readline()
            if not line:
                continue
            vals.extend(float(tok) for tok in line.split())
        arr = np.asarray(vals[:count])
        return arr.astype(np.int64) if kind == "int" else arr


_VTK_DTYPES = {
    "float": np.dtype(">f4"),
    "double": np.dtype(">f8"),
    "int": np.dtype(">i4"),
    "long": np.dtype(">i8"),
    "vtktypeint32": np.dtype(">i4"),
    "vtktypeint64": np.dtype(">i8"),
    "unsigned_char": np.dtype(">u1"),
    "unsigned_int": np.dtype(">u4"),
    "unsigned_long": np.dtype(">u8"),
}


def _read_array(tok: _Tokens, count: int, vtk_dtype: str, binary: bool) -> np.ndarray:
    dtype = _VTK_DTYPES[vtk_dtype.lower()]
    if binary:
        return tok.read_binary_array(count, dtype)
    kind = "int" if dtype.kind in "iu" else "float"
    return tok.read_ascii_numbers(count, kind)


def _read_cells_block(
    tok: _Tokens, header_parts: list[str], binary: bool
) -> np.ndarray:
    """Read a POLYGONS/CELLS block, returning (F, K) connectivity.

    Handles the classic layout (``POLYGONS n size`` followed by per-cell
    ``npts id0 id1 ...``) and the VTK 5.1 layout (``POLYGONS n_offsets
    n_conn`` followed by OFFSETS and CONNECTIVITY sub-arrays).
    """
    a, b = int(header_parts[1]), int(header_parts[2])
    nxt = tok.peekline()
    if nxt.upper().startswith("OFFSETS"):
        line = tok.readline().split()
        offsets = _read_array(tok, a, line[1], binary)
        line = tok.readline().split()
        assert line[0].upper() == "CONNECTIVITY", f"expected CONNECTIVITY, got {line}"
        conn = _read_array(tok, b, line[1], binary)
        counts = np.diff(offsets.astype(np.int64))
        if len(counts) == 0:
            return np.zeros((0, 3), dtype=np.int64)
        k = int(counts[0])
        assert np.all(counts == k), "mixed element types unsupported"
        return conn.astype(np.int64).reshape(-1, k)
    # Classic layout: `b` total ints.
    flat = _read_array(tok, b, "int", binary).astype(np.int64)
    if a == 0:
        return np.zeros((0, 3), dtype=np.int64)
    k = int(flat[0])
    cells = flat.reshape(a, k + 1)
    assert np.all(cells[:, 0] == k), "mixed element types unsupported"
    return cells[:, 1:]


def read_vtk(path: str | Path) -> SurfaceMesh:
    """Read a legacy .vtk POLYDATA or UNSTRUCTURED_GRID surface mesh."""
    raw = Path(path).read_bytes()
    tok = _Tokens(raw)
    version_line = tok.readline()
    assert version_line.startswith("# vtk"), f"not a legacy VTK file: {version_line}"
    tok.readline()  # title
    fmt = tok.readline().upper()
    binary = fmt == "BINARY"
    dataset_line = tok.readline().split()
    assert dataset_line[0].upper() == "DATASET"
    kind = dataset_line[1].upper()
    assert kind in ("POLYDATA", "UNSTRUCTURED_GRID"), f"unsupported dataset {kind}"

    points: np.ndarray | None = None
    faces: np.ndarray | None = None
    while not tok.at_eof():
        line = tok.readline()
        if not line:
            continue
        parts = line.split()
        key = parts[0].upper()
        if key == "POINTS":
            n = int(parts[1])
            points = _read_array(tok, n * 3, parts[2], binary).reshape(n, 3)
            points = points.astype(np.float64)
        elif key in ("POLYGONS", "CELLS"):
            faces = _read_cells_block(tok, parts, binary)
        elif key == "CELL_TYPES":
            _read_array(tok, int(parts[1]), "int", binary)
        elif key in ("POINT_DATA", "CELL_DATA", "FIELD", "METADATA"):
            break  # attributes not needed for graph construction
    assert points is not None, "VTK file has no POINTS"
    assert faces is not None, "VTK file has no cells"
    # Drop degenerate line cells if any slipped in (reference filters to
    # triangles via extract_cells_by_type, generate_dataset.py:188-190).
    return SurfaceMesh(points=points, faces=faces)


def write_vtk(
    path: str | Path, mesh: SurfaceMesh, binary: bool = True, title: str = "mesh"
) -> None:
    """Write a legacy .vtk POLYDATA file (classic cell layout), byte for byte
    as the JAX package's ``write_vtk``."""
    pts = np.ascontiguousarray(mesh.points, dtype=np.float64)
    faces = np.ascontiguousarray(mesh.faces, dtype=np.int64)
    f_count, k = faces.shape
    cells = np.empty((f_count, k + 1), dtype=np.int64)
    cells[:, 0] = k
    cells[:, 1:] = faces
    with open(path, "wb") as fh:
        fh.write(b"# vtk DataFile Version 4.2\n")
        fh.write(title.encode("ascii") + b"\n")
        fh.write(b"BINARY\n" if binary else b"ASCII\n")
        fh.write(b"DATASET POLYDATA\n")
        fh.write(f"POINTS {pts.shape[0]} double\n".encode())
        if binary:
            fh.write(pts.astype(">f8").tobytes())
            fh.write(b"\n")
        else:
            np.savetxt(fh, pts, fmt="%.17g")
        fh.write(f"POLYGONS {f_count} {cells.size}\n".encode())
        if binary:
            fh.write(cells.astype(">i4").tobytes())
            fh.write(b"\n")
        else:
            np.savetxt(fh, cells, fmt="%d")


def load_sample_npz(path: str | Path) -> dict[str, np.ndarray]:
    """Load a per-sample field .npz (same keys as the reference generator,
    `generate_dataset.py:586-598`)."""
    with np.load(path) as data:
        return dict(data)


def save_sample_npz(path: str | Path, **arrays: np.ndarray) -> None:
    """Write a per-sample field .npz (the keys ``load_sample_npz`` reads)."""
    np.savez(path, **arrays)
