"""The port's native graph library (``graphs/native.py`` over
``p_div_gnn_tpu_torch/csrc/graphcore.cpp``) against its numpy paths and the
JAX package's, the counterparts of ``tests/test_native.py``: the edge
index, the node labels and the periodic pairs are array-equal, and a mesh
with one boundary region is refused. The port's copy of the C++ source is
the JAX package's ``csrc/graphcore.cpp`` byte for byte below its header
comment. g++ is there wherever these tests run
(the JAX package's own native tests need it too)."""

from pathlib import Path

import numpy as np
import pytest

from p_div_gnn_tpu.graphs import native as jax_native
from p_div_gnn_tpu.graphs.build import faces_to_edge_index as jax_edges
from p_div_gnn_tpu.graphs.labels import compute_node_labels as jax_labels
from p_div_gnn_tpu.graphs.periodic import periodic_boundary_pairs as jax_pairs
from p_div_gnn_tpu_torch.datagen.mesher import hole_plate_mesh, hole_plate_mesh_quad
from p_div_gnn_tpu_torch.graphs import native
from p_div_gnn_tpu_torch.graphs.build import faces_to_edge_index
from p_div_gnn_tpu_torch.graphs.labels import compute_node_labels
from p_div_gnn_tpu_torch.graphs.periodic import periodic_boundary_pairs

from toy_meshes import grid_mesh, grid_mesh_with_hole

MESHES = {
    "grid_with_hole": lambda: grid_mesh_with_hole(7, 7, hole_cell=(3, 3)),
    "plate": lambda: hole_plate_mesh(100.0, 100.0, 20.0, (45.0, 55.0), 4.0, 10.0, seed=1),
    "plate_quad": lambda: hole_plate_mesh_quad(100.0, 100.0, 20.0, (45.0, 55.0), 4.0, 10.0),
}


@pytest.fixture
def numpy_paths():
    """Run the callers with the library unavailable (their numpy paths)."""
    def run(fn, *args):
        with native.disabled():
            return fn(*args)
    return run


def test_native_library_builds():
    assert native.available(), native.build_error
    assert native.library_path().is_file()
    assert native.library_path().parent.name == "p_div_gnn_tpu_torch"


@pytest.mark.parametrize("name", list(MESHES))
def test_native_faces_to_edges_matches(name, numpy_paths):
    mesh = MESHES[name]()
    fast = native.faces_to_edge_index(mesh.faces, mesh.n_points)
    slow = numpy_paths(faces_to_edge_index, mesh.faces, mesh.n_points)
    np.testing.assert_array_equal(fast, slow)
    np.testing.assert_array_equal(fast, jax_edges(mesh.faces, mesh.n_points))
    np.testing.assert_array_equal(faces_to_edge_index(mesh.faces, mesh.n_points), fast)
    keys = fast[0] * mesh.n_points + fast[1]
    assert np.all(np.diff(keys) > 0)  # canonical coalesced order


@pytest.mark.parametrize("name", list(MESHES))
def test_native_labels_match_numpy(name, numpy_paths):
    mesh = MESHES[name]()
    fast = native.compute_node_labels(mesh.faces, mesh.points[:, :2])
    np.testing.assert_array_equal(fast, numpy_paths(compute_node_labels, mesh))
    np.testing.assert_array_equal(fast, jax_labels(mesh))
    np.testing.assert_array_equal(compute_node_labels(mesh), fast)


@pytest.mark.parametrize("name", ["grid", "plate", "plate_quad"])
def test_native_periodic_pairs_match_numpy(name, numpy_paths):
    mesh = grid_mesh(5, 5) if name == "grid" else MESHES[name]()
    pts = mesh.points[:, :2]
    fast = native.periodic_pairs(pts)
    slow = numpy_paths(periodic_boundary_pairs, pts)
    for a, b, c in zip(fast, slow, jax_pairs(pts)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_native_label_assert_on_one_region(numpy_paths):
    """One boundary region: the native path, the numpy path and the JAX
    package's (an assert there) all refuse the mesh."""
    mesh = grid_mesh(4, 4)
    with pytest.raises(ValueError, match="Expected 2 regions, found 1"):
        native.compute_node_labels(mesh.faces, mesh.points[:, :2])
    with pytest.raises(ValueError, match="Expected 2 regions, found 1"):
        numpy_paths(compute_node_labels, mesh)
    if jax_native.available():
        with pytest.raises(AssertionError):
            jax_native.compute_node_labels(mesh.faces, mesh.points[:, :2])


def test_no_native_env_takes_the_numpy_paths(monkeypatch):
    monkeypatch.setenv("PDG_NO_NATIVE", "1")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    assert not native.available() and "PDG_NO_NATIVE" in native.build_error
    mesh = MESHES["plate"]()
    assert native.faces_to_edge_index(mesh.faces, mesh.n_points) is None
    np.testing.assert_array_equal(compute_node_labels(mesh), jax_labels(mesh))


def _code(path: Path) -> bytes:
    """The source from its first ``#include`` on: the code below the header
    comment."""
    raw = path.read_bytes()
    return raw[raw.index(b"\n#include") + 1:]


def test_native_source_is_the_jax_packages_copy():
    root = Path(__file__).resolve().parents[1]
    assert native.SOURCE == root / "p_div_gnn_tpu_torch" / "csrc" / "graphcore.cpp"
    assert _code(native.SOURCE) == _code(root / "csrc" / "graphcore.cpp")
