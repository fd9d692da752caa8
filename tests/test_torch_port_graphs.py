"""The port's host-side graph pipeline (p_div_gnn_tpu_torch.graphs,
p_div_gnn_tpu_torch.datagen) against the JAX package's: the same inputs must
give ARRAY-EQUAL meshes, graphs, labels, VTK reads and packed batches, and
the same per-mesh predictions after unpacking."""

import dataclasses

import numpy as np
import pytest

from p_div_gnn_tpu.datagen.mesher import hole_plate_mesh as jax_hole_plate_mesh
from p_div_gnn_tpu.datagen.opdiv import compute_op_div_matrix
from p_div_gnn_tpu.graphs import batching as jax_batching
from p_div_gnn_tpu.graphs import meshio as jax_meshio
from p_div_gnn_tpu.graphs.build import mesh_to_graph as jax_mesh_to_graph
from p_div_gnn_tpu.graphs.labels import compute_node_labels as jax_labels
from p_div_gnn_tpu.graphs.periodic import compute_periodic_graph as jax_periodic
from p_div_gnn_tpu_torch.datagen.mesher import hole_plate_mesh
from p_div_gnn_tpu_torch.graphs import batching, meshio
from p_div_gnn_tpu_torch.graphs.build import mesh_to_graph
from p_div_gnn_tpu_torch.graphs.labels import compute_node_labels
from p_div_gnn_tpu_torch.graphs.periodic import compute_periodic_graph

MESH_KW = dict(hole_center=(50.0, 50.0), hole_refinement_factor=3.0,
               global_mesh_refinement_size=12.5)


def _port_sample(seed: int) -> batching.GraphSample:
    rng = np.random.default_rng(seed)
    mesh = hole_plate_mesh(100.0, 100.0, radius=float(rng.uniform(15, 30)),
                           seed=seed, **MESH_KW)
    g = compute_periodic_graph(mesh_to_graph(mesh))
    op = compute_op_div_matrix(mesh.points[:, :2], mesh.faces)
    n = g.num_nodes
    return batching.GraphSample(
        graph=g,
        mean_stress=rng.normal(size=3).astype(np.float32),
        local_stress=rng.normal(size=(n, 3)).astype(np.float32),
        node_labels=compute_node_labels(mesh),
        div_data=op.data.astype(np.float32),
        div_row=op.row.astype(np.int64),
        div_col=op.col.astype(np.int64),
    )


def _to_jax_sample(s: batching.GraphSample) -> jax_batching.GraphSample:
    from p_div_gnn_tpu.graphs.build import MeshGraph

    fields = {f.name: getattr(s, f.name) for f in dataclasses.fields(s)}
    fields["graph"] = MeshGraph(**dataclasses.asdict(s.graph))
    return jax_batching.GraphSample(**fields)


@pytest.mark.parametrize("seed", [0, 3])
def test_mesh_graph_labels_match_jax(seed):
    """Mesher, mesh→graph, periodic edges and node labels: array equality."""
    kw = dict(radius=18.0 + seed, seed=seed, **MESH_KW)
    mesh = hole_plate_mesh(100.0, 100.0, **kw)
    ref = jax_hole_plate_mesh(100.0, 100.0, **kw)
    np.testing.assert_array_equal(mesh.points, ref.points)
    np.testing.assert_array_equal(mesh.faces, ref.faces)

    g, g_ref = mesh_to_graph(mesh), jax_mesh_to_graph(ref)
    p, p_ref = compute_periodic_graph(g), jax_periodic(g_ref)
    for a, b in ((g, g_ref), (p, p_ref)):
        np.testing.assert_array_equal(a.edge_index, b.edge_index)
        np.testing.assert_array_equal(a.edge_weight, b.edge_weight)
        np.testing.assert_array_equal(a.pos, b.pos)
        assert (a.org_num_edges, a.is_periodic) == (b.org_num_edges, b.is_periodic)
    np.testing.assert_array_equal(compute_node_labels(mesh), jax_labels(ref))


@pytest.mark.parametrize("binary", [True, False])
def test_read_vtk_matches_jax(tmp_path, binary):
    mesh = jax_hole_plate_mesh(100.0, 100.0, radius=20.0, seed=1, **MESH_KW)
    path = tmp_path / "mesh.vtk"
    jax_meshio.write_vtk(path, mesh, binary=binary)
    got, ref = meshio.read_vtk(path), jax_meshio.read_vtk(path)
    np.testing.assert_array_equal(got.points, ref.points)
    np.testing.assert_array_equal(got.faces, ref.faces)


@pytest.mark.parametrize("reorder", [None, "rcm"])
@pytest.mark.parametrize("n_extra_graphs", [0, 1])
def test_pack_batch_matches_jax(reorder, n_extra_graphs):
    """Every field of the port's batch equals the JAX packer's (dtype,
    shape and values), with the sender view and the div ELL views."""
    samples = [_port_sample(s) for s in (0, 1, 2)]
    G = len(samples) + n_extra_graphs
    got = batching.pack_batch(samples, n_graphs=G, reorder=reorder)
    ref = jax_batching.pack_batch([_to_jax_sample(s) for s in samples],
                                  n_graphs=G, reorder=reorder)
    assert (got.n_graphs, got.tile) == (ref.n_graphs, ref.tile)
    for name in got.array_fields():
        a, b = getattr(got, name), getattr(ref, name)
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == np.asarray(b).dtype, name
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)


def test_unpack_predictions_matches_jax():
    samples = [_port_sample(s) for s in (4, 5)]
    got = batching.pack_batch(samples, n_graphs=3, reorder="rcm")
    ref = jax_batching.pack_batch([_to_jax_sample(s) for s in samples],
                                  n_graphs=3, reorder="rcm")
    pred = np.random.default_rng(0).normal(size=(got.num_nodes_padded, 3))
    out = batching.unpack_predictions(got, pred)
    out_ref = jax_batching.unpack_predictions(ref, pred)
    assert len(out) == len(out_ref) == 2
    for a, b in zip(out, out_ref):
        np.testing.assert_array_equal(a, b)
