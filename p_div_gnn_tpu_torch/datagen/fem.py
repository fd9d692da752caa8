"""Linear-elastic periodic-homogenization FEM (plane stress, P1 triangles
and Q4 quads) in numpy + scipy: the copy of ``p_div_gnn_tpu/datagen/fem.py``.

It solves the RVE problem under a prescribed macroscopic displacement
gradient (``solve_periodic_rve``) or a prescribed mean stress
(``solve_periodic_rve_neumann``) with periodic boundary conditions, and
gives the dataset generator's artifacts: nodal stress / strain fields and
bounding-box / material-volume mean stresses. The element geometry and the
gauss-point → node projection here also build the divergence operator
(``opdiv.py``).

Conventions (those of the JAX package):
- prescribed gradient G = [[eps_xx, 0], [gamma_xy, eps_yy]]: eps_xx and
  eps_yy are driven through the periodic shifts, the full shear gamma goes
  into u_y(x+W)-u_y(x) and u_x(y+H)-u_x(y)=0;
- dof layout is component-major (all u_x then all u_y), the layout the
  divergence operator's columns assume;
- field integrals use nodal quadrature ∫f ≈ Σ_e A_e·mean(f_nodes);
- the node nearest the bounding-box centre is pinned (rigid translation);
- the sparse systems are solved by scipy's direct solver.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla


def plane_stress_D(young: float, poisson: float) -> np.ndarray:
    f = young / (1.0 - poisson**2)
    return f * np.array(
        [
            [1.0, poisson, 0.0],
            [poisson, 1.0, 0.0],
            [0.0, 0.0, (1.0 - poisson) / 2.0],
        ]
    )


def triangle_geometry(
    points: np.ndarray, tris: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Per-element shape-function gradients and areas.

    Returns (grads, areas): grads (F, 3, 2) with grads[e, i] = ∇N_i on
    element e; areas (F,).
    """
    p = points[tris]  # (F, 3, 2)
    v1 = p[:, 1] - p[:, 0]
    v2 = p[:, 2] - p[:, 0]
    det = v1[:, 0] * v2[:, 1] - v1[:, 1] * v2[:, 0]  # 2·area (signed)
    areas = det / 2.0
    # ∇N_i from the linear map inverse
    b = np.empty((len(tris), 3, 2))
    b[:, 0, 0] = p[:, 1, 1] - p[:, 2, 1]
    b[:, 1, 0] = p[:, 2, 1] - p[:, 0, 1]
    b[:, 2, 0] = p[:, 0, 1] - p[:, 1, 1]
    b[:, 0, 1] = p[:, 2, 0] - p[:, 1, 0]
    b[:, 1, 1] = p[:, 0, 0] - p[:, 2, 0]
    b[:, 2, 1] = p[:, 1, 0] - p[:, 0, 0]
    grads = b / det[:, None, None]
    return grads, areas


# Q4 reference-element node coordinates (CCW) and bilinear shape
# derivatives dN_i/d(ξ,η) = [ξ_i(1+η_i η)/4, η_i(1+ξ_i ξ)/4].
_Q4_XI = np.array([[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0], [-1.0, 1.0]])


def _q4_dN_ref(xi: float, eta: float) -> np.ndarray:
    dN = np.empty((4, 2))
    dN[:, 0] = _Q4_XI[:, 0] * (1.0 + _Q4_XI[:, 1] * eta) / 4.0
    dN[:, 1] = _Q4_XI[:, 1] * (1.0 + _Q4_XI[:, 0] * xi) / 4.0
    return dN


def quad_geometry(
    points: np.ndarray, quads: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Centroid (1-point) shape-function gradients and shoelace areas for
    bilinear Q4 elements: grads (F, 4, 2), areas (F,). The single centroid
    gauss point keeps the per-element-value operators (divergence, node
    projection) structurally identical to the P1 path."""
    p = points[quads]  # (F, 4, 2)
    dN = _q4_dN_ref(0.0, 0.0)  # (4, 2)
    J = np.einsum("ia,fib->fab", dN, p)  # (F, 2, 2), J[a,b]=∂x_b/∂ξ_a
    # ∂ξ_a/∂x_b is the inverse of ∂x/∂ξ = Jᵀ (transpose matters for
    # skewed elements)
    Jinv = np.linalg.inv(np.swapaxes(J, 1, 2))
    grads = np.einsum("ia,fab->fib", dN, Jinv)  # ∂N_i/∂x_b
    areas = 0.5 * np.abs(
        sum(
            p[:, i, 0] * p[:, (i + 1) % 4, 1]
            - p[:, (i + 1) % 4, 0] * p[:, i, 1]
            for i in range(4)
        )
    )
    return grads, areas


def element_geometry(
    points: np.ndarray, faces: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Dispatch on element type: (F,3)→P1 triangles, (F,4)→Q4 quads."""
    if faces.shape[1] == 3:
        return triangle_geometry(points, faces)
    if faces.shape[1] == 4:
        return quad_geometry(points, faces)
    raise ValueError(f"unsupported element arity {faces.shape[1]}")


def assemble_stiffness(
    points: np.ndarray, faces: np.ndarray, D: np.ndarray
) -> sp.csr_matrix:
    """Global stiffness, component-major dofs (x-dofs 0..N-1, y-dofs N..2N-1).

    P1 triangles use the exact constant-gradient integral; Q4 quads use
    full 2×2 Gauss integration (1-point would leave hourglass modes)."""
    n = len(points)
    F = len(faces)
    k = faces.shape[1]
    if k == 3:
        grads, areas = triangle_geometry(points, faces)
        gp_list = [(grads, areas)]
    else:
        p = points[faces]  # (F, 4, 2)
        g = 1.0 / np.sqrt(3.0)
        gp_list = []
        for xi, eta in [(-g, -g), (g, -g), (g, g), (-g, g)]:
            dN = _q4_dN_ref(xi, eta)
            J = np.einsum("ia,fib->fab", dN, p)
            detJ = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
            grads = np.einsum(
                "ia,fab->fib", dN, np.linalg.inv(np.swapaxes(J, 1, 2))
            )
            gp_list.append((grads, detJ))  # gauss weight = 1
    Ke = np.zeros((F, 2 * k, 2 * k))
    for grads, w in gp_list:
        # B per element: strain [exx, eyy, gxy] from [ux..., uy...]
        B = np.zeros((F, 3, 2 * k))
        B[:, 0, 0:k] = grads[:, :, 0]
        B[:, 1, k:] = grads[:, :, 1]
        B[:, 2, 0:k] = grads[:, :, 1]
        B[:, 2, k:] = grads[:, :, 0]
        Ke += np.einsum("fki,kl,flj,f->fij", B, D, B, w)
    dofs = np.concatenate([faces, faces + n], axis=1)  # (F, 2k)
    rows = np.repeat(dofs, 2 * k, axis=1).ravel()
    cols = np.tile(dofs, (1, 2 * k)).ravel()
    K = sp.coo_matrix((Ke.ravel(), (rows, cols)), shape=(2 * n, 2 * n))
    return K.tocsr()


@dataclasses.dataclass
class PeriodicPairs:
    masters: np.ndarray  # (P,) node ids
    slaves: np.ndarray  # (P,) node ids
    shifts: np.ndarray  # (P, 2) x_slave - x_master


def periodic_node_pairs(points: np.ndarray, tol: float = 1e-9) -> PeriodicPairs:
    """Right→left, top→bottom, and the three non-origin corners→LL corner."""
    min_x, min_y = points.min(0)
    max_x, max_y = points.max(0)
    is_l = points[:, 0] == min_x
    is_r = points[:, 0] == max_x
    is_b = points[:, 1] == min_y
    is_t = points[:, 1] == max_y
    idx = np.arange(len(points))

    def match(slave_mask, master_mask, axis):
        s = idx[slave_mask]
        m = idx[master_mask]
        s = s[np.argsort(points[s, axis])]
        m = m[np.argsort(points[m, axis])]
        assert len(s) == len(m), "non-periodic mesh"
        assert np.allclose(points[s, axis], points[m, axis], atol=tol)
        return s, m

    # sides without corners
    r_s, r_m = match(is_r & ~is_b & ~is_t, is_l & ~is_b & ~is_t, axis=1)
    t_s, t_m = match(is_t & ~is_l & ~is_r, is_b & ~is_l & ~is_r, axis=0)
    ll = idx[is_l & is_b]
    lr = idx[is_r & is_b]
    ul = idx[is_l & is_t]
    ur = idx[is_r & is_t]
    assert len(ll) == len(lr) == len(ul) == len(ur) == 1
    c_s = np.array([lr[0], ul[0], ur[0]])
    c_m = np.array([ll[0], ll[0], ll[0]])
    slaves = np.concatenate([r_s, t_s, c_s])
    masters = np.concatenate([r_m, t_m, c_m])
    shifts = points[slaves] - points[masters]
    return PeriodicPairs(masters=masters, slaves=slaves, shifts=shifts)


@dataclasses.dataclass
class FEMResult:
    displacement: np.ndarray  # (N, 2)
    stress_nodes: np.ndarray  # (N, 3) [xx, yy, xy]
    strain_nodes: np.ndarray  # (N, 3) [exx, eyy, gxy]
    stress_elems: np.ndarray  # (F, 3)
    mean_stress: np.ndarray  # (3,) over bounding-box volume
    mean_stress_material: np.ndarray  # (3,) over material volume


def gausspoint_to_node_matrix(
    points: np.ndarray, tris: np.ndarray
) -> sp.csr_matrix:
    """Area-weighted projection of per-element (1 gauss pt) values to nodes:
    node value = Σ_e A_e v_e / Σ_e A_e over incident elements — the
    node-field projection fedoo's _get_gausspoint2node_mat performs.
    Element-type agnostic (P1 triangles or Q4 quads)."""
    n = len(points)
    k = tris.shape[1]
    _, areas = element_geometry(points, tris)
    rows = tris.ravel()
    cols = np.repeat(np.arange(len(tris)), k)
    w = np.repeat(areas, k)
    M = sp.coo_matrix((w, (rows, cols)), shape=(n, len(tris))).tocsr()
    norm = np.asarray(M.sum(axis=1)).ravel()
    inv = sp.diags(1.0 / np.maximum(norm, 1e-300))
    return inv @ M


@dataclasses.dataclass
class _Reduction:
    """Periodic master/slave dof reduction shared by both BC modes."""

    master_of: np.ndarray  # (N,) node → master node
    red_of: np.ndarray  # (N,) master node → reduced index (−1 for slaves)
    nr: int  # number of reduced nodes
    P: sp.csr_matrix  # (2N, 2nr) dof → reduced-dof incidence
    slave_shift: np.ndarray  # (N, 2) x_slave − x_master (0 for masters)
    center_red: int  # reduced index of the pinned center node


def _build_reduction(points2d: np.ndarray) -> _Reduction:
    n = len(points2d)
    pairs = periodic_node_pairs(points2d)
    master_of = np.arange(n)
    master_of[pairs.slaves] = pairs.masters
    # chains are length 1 (corners map directly to LL), no transitivity needed
    slave_shift = np.zeros((n, 2))
    slave_shift[pairs.slaves] = pairs.shifts

    keep = np.ones(n, dtype=bool)
    keep[pairs.slaves] = False
    red_of = -np.ones(n, dtype=np.int64)
    red_of[keep] = np.arange(keep.sum())
    nr = int(keep.sum())

    # center node pinned (rigid translation), `generate_dataset.py:233`
    bbox_center = (points2d.min(0) + points2d.max(0)) / 2.0
    center_node = int(np.argmin(np.linalg.norm(points2d - bbox_center, axis=1)))
    center_red = int(red_of[master_of[center_node]])
    assert center_red >= 0

    node_ids = np.arange(n)
    rows = np.concatenate([node_ids, node_ids + n])
    cols = np.concatenate(
        [red_of[master_of], red_of[master_of] + nr]
    )
    vals = np.ones(2 * n)
    P = sp.coo_matrix((vals, (rows, cols)), shape=(2 * n, 2 * nr)).tocsr()
    return _Reduction(
        master_of=master_of, red_of=red_of, nr=nr, P=P,
        slave_shift=slave_shift, center_red=center_red,
    )


def _fields_from_displacement(
    points2d: np.ndarray, tris: np.ndarray, u: np.ndarray, D: np.ndarray
) -> FEMResult:
    """Element strain/stress + node projection + volume-mean stresses.
    Element-type agnostic (P1: exact constant strain; Q4: centroid strain,
    the conventional reduced-integration post-processing point)."""
    n = len(points2d)
    grads, areas = element_geometry(points2d, tris)
    ue = u[tris]  # (F, K, 2)
    dudx = np.einsum("fid,fig->fdg", ue, grads)  # (F, 2, 2) du_d/dx_g
    exx = dudx[:, 0, 0]
    eyy = dudx[:, 1, 1]
    gxy = dudx[:, 0, 1] + dudx[:, 1, 0]
    strain_e = np.stack([exx, eyy, gxy], axis=1)
    stress_e = strain_e @ D.T

    g2n = gausspoint_to_node_matrix(points2d, tris)
    stress_n = g2n @ stress_e
    strain_n = g2n @ strain_e

    # nodal-quadrature integrals (fedoo integrate_field over node fields)
    def integrate_nodal(f: np.ndarray) -> np.ndarray:
        elem_mean = f[tris].mean(axis=1)
        return np.einsum("f,f...->...", areas, elem_mean)

    box = points2d.max(0) - points2d.min(0)
    v_box = float(box[0] * box[1])
    v_mat = float(integrate_nodal(np.ones(n)))
    mean_stress = integrate_nodal(stress_n) / v_box
    mean_stress_mat = integrate_nodal(stress_n) / v_mat

    return FEMResult(
        displacement=u,
        stress_nodes=stress_n,
        strain_nodes=strain_n,
        stress_elems=stress_e,
        mean_stress=np.asarray(mean_stress),
        mean_stress_material=np.asarray(mean_stress_mat),
    )


def solve_periodic_rve(
    points2d: np.ndarray,
    tris: np.ndarray,
    eps_xx: float,
    eps_yy: float,
    gamma_xy: float,
    young_modulus: float = 1e5,
    poisson_ratio: float = 0.3,
) -> FEMResult:
    """Dirichlet-controlled macroscopic strain with periodic fluctuations
    (`compute_mechanical_fields_dirichlet`, generate_dataset.py:195-303)."""
    n = len(points2d)
    D = plane_stress_D(young_modulus, poisson_ratio)
    K = assemble_stiffness(points2d, tris, D)

    G = np.array([[eps_xx, 0.0], [gamma_xy, eps_yy]])  # du_i/dx_j
    red = _build_reduction(points2d)
    nr, P = red.nr, red.P

    # Reduction u = P u_red + c: slave dof = master dof + (G·shift)_comp.
    const = red.slave_shift @ G.T  # (N, 2), zero rows for masters
    c_full = np.concatenate([const[:, 0], const[:, 1]])

    K_red = (P.T @ K @ P).tocsr()
    rhs = -P.T @ (K @ c_full)

    # pin the center node's two reduced dofs
    pinned = np.array([red.center_red, nr + red.center_red])
    free = np.setdiff1d(np.arange(2 * nr), pinned)
    K_ff = K_red[free][:, free]
    u_red = np.zeros(2 * nr)
    u_red[free] = spla.spsolve(K_ff.tocsc(), rhs[free])

    u_full = P @ u_red + c_full
    u = np.stack([u_full[:n], u_full[n:]], axis=1)
    return _fields_from_displacement(points2d, tris, u, D)


def solve_periodic_rve_neumann(
    points2d: np.ndarray,
    tris: np.ndarray,
    sigma_xx: float,
    sigma_yy: float,
    sigma_xy: float,
    young_modulus: float = 1e5,
    poisson_ratio: float = 0.3,
) -> FEMResult:
    """Stress-controlled (Neumann) periodic RVE
    (`compute_mechanical_fields_neumann`, generate_dataset.py:306-410).

    The macroscopic strain components E = (Exx, Eyy, Gxy) are retained as
    UNKNOWN generalized dofs coupled through the periodic constraints
    (u(slave) − u(master) = [Exx·dx, Gxy·dx + Eyy·dy]) and driven by the
    work-conjugate generalized forces σ·V_box on the three virtual strain
    dofs — exactly the reference's Neumann BCs on fedoo's virtual strain
    nodes (`generate_dataset.py:349-374`). By homogenization duality the
    resulting bounding-box mean stress equals the imposed σ (asserted in
    tests/test_fem.py). Like the reference, ``mean_stress`` in the result
    is the imposed σ; ``mean_stress_material`` is integrated from the
    solution (`generate_dataset.py:396-410`)."""
    n = len(points2d)
    D = plane_stress_D(young_modulus, poisson_ratio)
    K = assemble_stiffness(points2d, tris, D)

    red = _build_reduction(points2d)
    nr, P = red.nr, red.P

    # Strain-dof incidence C (2N, 3): slave dof constants per unit E.
    dx = red.slave_shift[:, 0]
    dy = red.slave_shift[:, 1]
    node_ids = np.arange(n)
    rows = np.concatenate([node_ids, node_ids + n, node_ids + n])
    cols = np.concatenate(
        [np.zeros(n, np.int64), np.ones(n, np.int64),
         np.full(n, 2, np.int64)]
    )
    vals = np.concatenate([dx, dy, dx])
    C = sp.coo_matrix((vals, (rows, cols)), shape=(2 * n, 3)).tocsr()

    A = sp.hstack([P, C]).tocsr()  # u = A z, z = [u_red; E]
    K_aug = (A.T @ K @ A).tocsr()

    box = points2d.max(0) - points2d.min(0)
    v_box = float(box[0] * box[1])
    rhs = np.zeros(2 * nr + 3)
    rhs[2 * nr + 0] = sigma_xx * v_box
    rhs[2 * nr + 1] = sigma_yy * v_box
    rhs[2 * nr + 2] = sigma_xy * v_box

    pinned = np.array([red.center_red, nr + red.center_red])
    free = np.setdiff1d(np.arange(2 * nr + 3), pinned)
    K_ff = K_aug[free][:, free]
    z = np.zeros(2 * nr + 3)
    z[free] = spla.spsolve(K_ff.tocsc(), rhs[free])

    u_full = A @ z
    u = np.stack([u_full[:n], u_full[n:]], axis=1)
    res = _fields_from_displacement(points2d, tris, u, D)
    return dataclasses.replace(
        res, mean_stress=np.array([sigma_xx, sigma_yy, sigma_xy])
    )
