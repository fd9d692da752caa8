"""The frozen input generators give the arrays the port's own give today,
and the pool and weights follow the seed."""

import numpy as np
import pytest
import torch

from perfbench.inputs import graph as frozen
from perfbench.inputs.mesher import hole_plate_mesh
from perfbench.inputs.pool import build_pool
from perfbench.inputs.weights import initial_weights, parameter_spec


@pytest.fixture(params=[(12.0, 2.0, 20.0, [5, 1, 0]), (2.5, 8.0, 27.5, [2**31 + 7, 1, 3])],
                ids=["small", "flagship"])
def meshes(request):
    from p_div_gnn_tpu_torch.datagen import mesher

    size, factor, radius, seed = request.param
    kw = dict(radius=radius, hole_center=(50.0, 50.0), hole_refinement_factor=factor,
              global_mesh_refinement_size=size, seed=seed)
    return hole_plate_mesh(100.0, 100.0, **kw), mesher.hole_plate_mesh(100.0, 100.0, **kw)


def test_mesher_is_the_port_s(meshes):
    (points, faces), port = meshes
    np.testing.assert_array_equal(points, port.points)
    np.testing.assert_array_equal(faces, port.faces)


def test_graph_labels_and_operator_are_the_port_s(meshes):
    from p_div_gnn_tpu_torch.datagen.opdiv import compute_op_div_matrix
    from p_div_gnn_tpu_torch.graphs.build import mesh_to_graph
    from p_div_gnn_tpu_torch.graphs.labels import compute_node_labels
    from p_div_gnn_tpu_torch.graphs.periodic import compute_periodic_graph

    (points, faces), port = meshes
    mine = frozen.periodic_graph(points, faces)
    theirs = compute_periodic_graph(mesh_to_graph(port))
    np.testing.assert_array_equal(mine["edge_index"], theirs.edge_index)
    np.testing.assert_array_equal(mine["edge_weight"], theirs.edge_weight)
    np.testing.assert_array_equal(mine["pos"], theirs.pos)
    assert mine["org_num_edges"] == theirs.org_num_edges
    np.testing.assert_array_equal(frozen.node_labels(points, faces), compute_node_labels(port))
    a, b = frozen.divergence_operator(points[:, :2], faces), compute_op_div_matrix(
        port.points[:, :2], port.faces)
    np.testing.assert_array_equal(a.row, b.row)
    np.testing.assert_array_equal(a.col, b.col)
    np.testing.assert_array_equal(a.data, b.data)


def test_pool_is_the_same_for_every_seed():
    spec = {"meshes": 4, "plate": [100.0, 100.0], "radius": [15.0, 30.0],
            "hole_refinement_factor": 2.0, "global_mesh_refinement_size": 12.0,
            "divergence_operator": True}
    a, b = build_pool(spec, workers=2), build_pool(spec, workers=1)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x["edge_index"], y["edge_index"])
        np.testing.assert_array_equal(x["div_data"], y["div_data"])
    assert len({m["radius"] for m in a}) == 4


def test_weights_follow_the_seed_and_fit_the_port():
    from p_div_gnn_tpu_torch.models.epd import EncodeProcessDecode

    w = initial_weights(16, 2**31 + 3, "cpu")
    model = EncodeProcessDecode(latent_size=16, message_passing_steps=2, scatter_impl="fused3")
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
        k: tuple(v.shape) for k, v in w.items()}
    model.load_state_dict(w)
    again = initial_weights(16, 2**31 + 3, "cpu")
    assert all(torch.equal(w[k], again[k]) for k in w)
    for name, _, init in parameter_spec(16):
        if isinstance(init, float):
            assert float(w[name].abs().max()) <= init


def test_pool_cache_is_read_back_and_keyed_by_the_spec(tmp_path):
    from perfbench.inputs.pool import PoolBuilder, cache_file

    spec = {"meshes": 2, "plate": [100.0, 100.0], "radius": [15.0, 30.0],
            "hole_refinement_factor": 2.0, "global_mesh_refinement_size": 12.0,
            "divergence_operator": True}
    built = PoolBuilder(spec, workers=1, cache=tmp_path).result()
    assert cache_file(spec, tmp_path).is_file()
    again = PoolBuilder(spec, workers=1, cache=tmp_path)
    assert again.workers == 0  # read, not meshed
    for x, y in zip(built, again.result()):
        for key in ("edge_index", "div_data", "labels", "points"):
            np.testing.assert_array_equal(x[key], y[key])
    assert cache_file(dict(spec, meshes=3), tmp_path) != cache_file(spec, tmp_path)
