"""The port's FEM and Neo-Hookean solvers and its two mesher additions
against the JAX package's (``p_div_gnn_tpu/datagen/{fem,hyperelastic,
mesher}.py``), on the same inputs:

- the linear periodic RVE solve on a small P1 mesh and a small Q4 mesh, in
  Dirichlet (strain) and Neumann (stress) modes: displacement,
  ``stress_nodes``, ``mean_stress`` and ``mean_stress_material`` within
  rtol 1e-10 / atol 1e-12 (float64 in both), and the stiffness matrix;
- ``hole_plate_mesh_quad`` and ``is_periodic_mesh``: points and faces
  array-equal for three seeds;
- the Neo-Hookean solver: Piola and Cauchy stresses on random deformation
  gradients at rtol 1e-12, the solve on a mesh of a few hundred nodes at
  rtol 1e-8 on the fields and mean stresses, the deformed divergence
  operator equal, and a Newton failure raising alike in both."""

import numpy as np
import pytest

from p_div_gnn_tpu.datagen import fem as jax_fem
from p_div_gnn_tpu.datagen import hyperelastic as jax_hyper
from p_div_gnn_tpu.datagen import mesher as jax_mesher
from p_div_gnn_tpu_torch.datagen import fem, hyperelastic, mesher

RTOL, ATOL = 1e-10, 1e-12
HYPER_RTOL = 1e-8


def _mesh(element: str, seed: int = 0, global_size: float = 12.0):
    rng = np.random.default_rng(seed)
    kw = dict(width=100.0, height=100.0, radius=float(rng.uniform(15, 25)),
              hole_center=(float(rng.uniform(40, 60)), float(rng.uniform(40, 60))),
              hole_refinement_factor=3.0, global_mesh_refinement_size=global_size)
    if element == "tri":
        return mesher.hole_plate_mesh(seed=seed, **kw), jax_mesher.hole_plate_mesh(seed=seed,
                                                                                   **kw)
    return mesher.hole_plate_mesh_quad(seed=seed, **kw), jax_mesher.hole_plate_mesh_quad(
        seed=seed, **kw)


def _assert_result(got, want, rtol, atol):
    for field in ("displacement", "stress_nodes", "strain_nodes", "stress_elems",
                  "mean_stress", "mean_stress_material"):
        np.testing.assert_allclose(getattr(got, field), getattr(want, field), rtol=rtol,
                                   atol=atol, err_msg=field)


@pytest.mark.parametrize("element", ["tri", "quad"])
@pytest.mark.parametrize("bc", ["dirichlet", "neumann"])
def test_linear_solve_matches_jax(element, bc):
    mesh, ref = _mesh(element)
    np.testing.assert_array_equal(mesh.faces, ref.faces)
    pts = mesh.points[:, :2]
    load = (0.02, -0.01, 0.015)
    if bc == "dirichlet":
        got = fem.solve_periodic_rve(pts, mesh.faces, *load)
        want = jax_fem.solve_periodic_rve(ref.points[:, :2], ref.faces, *load)
    else:
        sig = fem.plane_stress_D(1e5, 0.3) @ np.array(load)
        np.testing.assert_array_equal(sig, jax_fem.plane_stress_D(1e5, 0.3) @ np.array(load))
        got = fem.solve_periodic_rve_neumann(pts, mesh.faces, *sig)
        want = jax_fem.solve_periodic_rve_neumann(ref.points[:, :2], ref.faces, *sig)
    assert np.abs(got.stress_nodes).max() > 0
    _assert_result(got, want, RTOL, ATOL)
    D = fem.plane_stress_D(1e5, 0.3)
    K, K_ref = fem.assemble_stiffness(pts, mesh.faces, D), jax_fem.assemble_stiffness(
        ref.points[:, :2], ref.faces, D)
    assert (K != K_ref).nnz == 0
    pairs, pairs_ref = fem.periodic_node_pairs(pts), jax_fem.periodic_node_pairs(pts)
    for k in ("masters", "slaves", "shifts"):
        np.testing.assert_array_equal(getattr(pairs, k), getattr(pairs_ref, k))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quad_mesher_and_periodicity_match_jax(seed):
    mesh, ref = _mesh("quad", seed)
    np.testing.assert_array_equal(mesh.points, ref.points)
    np.testing.assert_array_equal(mesh.faces, ref.faces)
    tri, tri_ref = _mesh("tri", seed)
    for m in (mesh, tri):
        pts = m.points[:, :2]
        assert mesher.is_periodic_mesh(pts) == jax_mesher.is_periodic_mesh(pts) is True
    # one boundary node moved: neither package calls it periodic
    pts = tri.points[:, :2].copy()
    edge = np.flatnonzero((pts[:, 0] == 0.0) & (pts[:, 1] > 0) & (pts[:, 1] < 100))[0]
    pts[edge, 1] += 0.5
    assert mesher.is_periodic_mesh(pts) == jax_mesher.is_periodic_mesh(pts) is False


def test_piola_and_cauchy_stresses_match_jax():
    rng = np.random.default_rng(0)
    F = np.eye(2) + 0.2 * rng.normal(size=(64, 2, 2))
    for name in ("piola_stress", "cauchy_stress"):
        got, want = getattr(hyperelastic, name)(F), getattr(jax_hyper, name)(F)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0, err_msg=name)
    np.testing.assert_allclose(hyperelastic._element_tangent(F), jax_hyper._element_tangent(F),
                               rtol=1e-12, atol=1e-12)


def test_neohookean_solve_matches_jax():
    mesh, ref = _mesh("tri", 3, global_size=8.0)
    assert 150 <= mesh.n_points <= 600
    pts = mesh.points[:, :2]
    load = (0.08, -0.05, 0.06)
    got = hyperelastic.solve_periodic_rve_neohookean(pts, mesh.faces, *load)
    want = jax_hyper.solve_periodic_rve_neohookean(ref.points[:, :2], ref.faces, *load)
    _assert_result(got, want, HYPER_RTOL, 1e-12)
    op = hyperelastic.deformed_op_div_matrix(pts, mesh.faces, got.displacement)
    op_ref = jax_hyper.deformed_op_div_matrix(pts, mesh.faces, got.displacement)
    for k in ("data", "row", "col"):
        np.testing.assert_array_equal(getattr(op, k), getattr(op_ref, k))
    assert op.shape == op_ref.shape


def test_newton_failure_raises_alike():
    mesh, _ = _mesh("tri", 3)
    pts = mesh.points[:, :2]
    kw = dict(max_iter=1, dt_min=0.01)  # one iteration never converges: the step halves out
    with pytest.raises(RuntimeError) as got:
        hyperelastic.solve_periodic_rve_neohookean(pts, mesh.faces, 0.1, 0.1, 0.1, **kw)
    with pytest.raises(RuntimeError) as want:
        jax_hyper.solve_periodic_rve_neohookean(pts, mesh.faces, 0.1, 0.1, 0.1, **kw)
    assert str(got.value) == str(want.value)
