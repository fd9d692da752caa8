"""The port's losses, divergence operator, training workload and batch
fields against the JAX package on the same (array-equal) batches: values
and gradients with respect to the prediction, padding graphs included.

Tolerances: the divergence operator and the workload are numpy code copied
from the JAX package, so they must be array-equal; the losses are fp32
reductions taken in another order (the port's segment sums add in fp64),
held at rtol 1e-5 / atol 1e-6, and their gradients at rtol 1e-4 / atol
1e-6."""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p_div_gnn_tpu import losses as jax_losses
from p_div_gnn_tpu.datagen.mesher import hole_plate_mesh as jax_hole_plate_mesh
from p_div_gnn_tpu.datagen.opdiv import compute_op_div_matrix as jax_op_div
from p_div_gnn_tpu.datagen.opdiv import compute_op_mean_stress as jax_op_mean
from p_div_gnn_tpu.graphs.batching import pack_batch as jax_pack_batch
from p_div_gnn_tpu.graphs.container import NormStats as JaxNormStats
from p_div_gnn_tpu_torch import losses
from p_div_gnn_tpu_torch.datagen.mesher import hole_plate_mesh
from p_div_gnn_tpu_torch.datagen.opdiv import compute_op_div_matrix, compute_op_mean_stress
from p_div_gnn_tpu_torch.datagen.workload import build_workload
from p_div_gnn_tpu_torch.graphs.batching import pack_batch
from p_div_gnn_tpu_torch.graphs.container import NormStats

from test_torch_port_graphs import MESH_KW, _port_sample, _to_jax_sample

REPO = Path(__file__).resolve().parents[1]
T = torch.from_numpy


@pytest.fixture(scope="module")
def batches():
    """Two meshes in a batch of three graphs (one padding graph), with and
    without the divergence ELL views."""
    samples = [_port_sample(s) for s in (0, 1)]
    jsamples = [_to_jax_sample(s) for s in samples]
    out = {}
    for ell in (True, False):
        out[ell] = (pack_batch(samples, n_graphs=3, reorder="rcm", div_ell=ell),
                    jax_pack_batch(jsamples, n_graphs=3, reorder="rcm", div_ell=ell))
    return out


def _fields(n_nodes, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n_nodes, 3)).astype(np.float32),
            rng.normal(size=(n_nodes, 3)).astype(np.float32))


def _check_fn(port_fn, jax_fn, pred, *rest):
    """Value and gradient w.r.t. the prediction of a scalar-reduced loss."""
    w = np.random.default_rng(9).normal(size=np.shape(jax_fn(jnp.asarray(pred), *rest)))
    want, want_grad = jax.value_and_grad(
        lambda p: jnp.sum(jax_fn(p, *rest) * w))(jnp.asarray(pred))
    p = T(pred).requires_grad_()
    got = (port_fn(p, *(T(r) if isinstance(r, np.ndarray) else r for r in rest))
           * T(w).float()).sum()
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_grad), rtol=1e-4, atol=1e-6)


def test_per_graph_nmse_matches_jax(batches):
    host, ref = batches[True]
    pred, gt = _fields(host.num_nodes_padded, 0)
    b = host.to("cpu")
    _check_fn(lambda p, g: losses.per_graph_nmse(b, p, g),
              lambda p, g: jax_losses.per_graph_nmse(ref, p, g), pred, gt)


@pytest.mark.parametrize("zero_internal", [True, False])
@pytest.mark.parametrize("ell", [True, False], ids=["ell", "coo"])
def test_divergence_field_matches_jax(batches, ell, zero_internal):
    host, ref = batches[ell]
    assert (host.div_src is not None) == ell
    pred, _ = _fields(host.num_nodes_padded, 1)
    b = host.to("cpu")
    _check_fn(lambda p: losses.divergence_field(b, p, zero_internal),
              lambda p: jax_losses.divergence_field(ref, p, zero_internal), pred)


@pytest.mark.parametrize("strategy", ["square", "abs"])
def test_per_graph_divergence_matches_jax(batches, strategy):
    host, ref = batches[True]
    pred, _ = _fields(host.num_nodes_padded, 2)
    b = host.to("cpu")
    _check_fn(lambda p: losses.per_graph_divergence(b, p, strategy),
              lambda p: jax_losses.per_graph_divergence(ref, p, strategy), pred)


@pytest.mark.parametrize("optimize_divergence", [True, False])
def test_batch_loss_matches_jax(batches, optimize_divergence):
    host, ref = batches[True]
    pred, gt = _fields(host.num_nodes_padded, 3)
    b = host.to("cpu")
    assert b.graph_mask.tolist() == [True, True, False] and b.n_real_graphs == 2

    def port(p, g):
        total, aux = losses.batch_loss(b, p, g, 10.0, optimize_divergence)
        assert set(aux) == ({"nmse", "divergence"} if optimize_divergence else {"nmse"})
        return total

    _check_fn(port, lambda p, g: jax_losses.batch_loss(ref, p, g, 10.0, optimize_divergence)[0],
              pred, gt)


@pytest.mark.parametrize("quads", [False, True])
def test_divergence_operator_matches_jax(quads):
    """compute_op_div_matrix and compute_op_mean_stress: array equality (the
    same numpy arithmetic), on triangles and on quads made of triangle pairs."""
    mesh = hole_plate_mesh(100.0, 100.0, radius=20.0, seed=4, **MESH_KW)
    ref = jax_hole_plate_mesh(100.0, 100.0, radius=20.0, seed=4, **MESH_KW)
    pts, faces = mesh.points[:, :2], mesh.faces
    if quads:  # degenerate quads (a triangle with a repeated last vertex)
        faces = np.concatenate([faces, faces[:, 2:3]], axis=1)
    got, want = compute_op_div_matrix(pts, faces), jax_op_div(ref.points[:, :2], faces)
    for field in ("row", "col", "data"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    np.testing.assert_array_equal(compute_op_mean_stress(pts, faces),
                                  jax_op_mean(ref.points[:, :2], faces))


def test_workload_matches_bench_build_workload():
    """The port's home for bench.py::build_workload packs the same batch as
    bench.py's own (two meshes of the flagship generator)."""
    spec = importlib.util.spec_from_file_location("bench_for_port_test", REPO / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    got, got_e, got_n = build_workload(n_graphs=2, seed=0)
    want, want_e, want_n = bench.build_workload(n_graphs=2, seed=0)
    assert (got_e, got_n) == (want_e, want_n)
    for name in got.array_fields():
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)
    assert (got.n_graphs, got.tile) == (want.n_graphs, want.tile)


def test_norm_stats_ones_and_to_dict():
    got, want = NormStats.ones(), JaxNormStats.ones()
    assert got.to_dict() == want.to_dict()
    assert NormStats.from_dict(got.to_dict()) == got
    assert dataclasses.asdict(got) == got.to_dict()
