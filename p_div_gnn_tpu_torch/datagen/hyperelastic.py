"""Finite-strain Neo-Hookean periodic RVE solver: the copy of
``p_div_gnn_tpu/datagen/hyperelastic.py``, in numpy + scipy.

The model and loading, as the JAX package's:
- plane strain, total-Lagrangian;
- compressible Neo-Hookean, W = C10·(J^{-2/3}·I1 − 3) + κ/2·(J − 1)² with
  I1 = tr(FᵀF) + 1, C10 = 1.5, κ = 10;
- the macroscopic displacement gradient is the SYMMETRIC
  Ḡ = [[εxx, γ/2], [γ/2, εyy]];
- incremental loading with a Newton-Raphson loop per step (tolerance 1e-3
  on the residual relative to the step's first one), step growth after two
  converged steps and step halving on failure; a solve whose step falls
  below ``dt_min`` raises, and the generator skips that sample;
- outputs: nodal CAUCHY stress, mean stress over the DEFORMED bounding-box
  volume det(F̄)·V, and the divergence operator assembled on the DEFORMED
  mesh (``deformed_op_div_matrix``).

Implementation: analytic first Piola-Kirchhoff stress, consistent element
tangent by vectorized central differences of P(F) (h = 1e-7, float64),
periodic constraint elimination shared with the linear solver, sparse direct
solve.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from p_div_gnn_tpu_torch.datagen.fem import (
    FEMResult,
    gausspoint_to_node_matrix,
    periodic_node_pairs,
    triangle_geometry,
)

C10 = 1.5
KAPPA = 10.0


def piola_stress(F: np.ndarray) -> np.ndarray:
    """First PK stress for plane-strain compressible Neo-Hookean.

    F: (..., 2, 2). Returns (..., 2, 2).
    """
    J = F[..., 0, 0] * F[..., 1, 1] - F[..., 0, 1] * F[..., 1, 0]
    I1 = np.einsum("...ij,...ij->...", F, F) + 1.0  # + λ3²=1 (plane strain)
    Finv_T = np.empty_like(F)
    Finv_T[..., 0, 0] = F[..., 1, 1]
    Finv_T[..., 0, 1] = -F[..., 1, 0]
    Finv_T[..., 1, 0] = -F[..., 0, 1]
    Finv_T[..., 1, 1] = F[..., 0, 0]
    Finv_T = Finv_T / J[..., None, None]  # (adj F)ᵀ / J = F^{-T}
    Jm23 = J ** (-2.0 / 3.0)
    scal = (-2.0 / 3.0) * C10 * I1 * Jm23 + KAPPA * (J - 1.0) * J
    return 2.0 * C10 * Jm23[..., None, None] * F + scal[..., None, None] * Finv_T


def cauchy_stress(F: np.ndarray) -> np.ndarray:
    """σ = P Fᵀ / J, in-plane components (..., 2, 2)."""
    P = piola_stress(F)
    J = F[..., 0, 0] * F[..., 1, 1] - F[..., 0, 1] * F[..., 1, 0]
    return np.einsum("...ik,...jk->...ij", P, F) / J[..., None, None]


def _element_tangent(F: np.ndarray, h: float = 1e-7) -> np.ndarray:
    """dP/dF (..., 2, 2, 2, 2) by central differences (vectorized)."""
    out = np.empty(F.shape[:-2] + (2, 2, 2, 2))  # [..., i, j, k, l]
    for k in range(2):
        for l in range(2):
            dF = np.zeros_like(F)
            dF[..., k, l] = h
            # dims [..., i, j] at fixed trailing (k, l): dP_ij/dF_kl
            out[..., :, :, k, l] = (
                piola_stress(F + dF) - piola_stress(F - dF)
            ) / (2 * h)
    return out


def solve_periodic_rve_neohookean(
    points2d: np.ndarray,
    tris: np.ndarray,
    eps_xx: float,
    eps_yy: float,
    gamma_xy: float,
    dt: float = 0.02,
    tol: float = 1e-3,
    max_iter: int = 12,
    dt_min: float = 1e-4,
) -> FEMResult:
    n = len(points2d)
    grads, areas = triangle_geometry(points2d, tris)  # reference config
    pairs = periodic_node_pairs(points2d)
    G_target = np.array(
        [[eps_xx, gamma_xy / 2.0], [gamma_xy / 2.0, eps_yy]]
    )

    master_of = np.arange(n)
    master_of[pairs.slaves] = pairs.masters
    keep = np.ones(n, dtype=bool)
    keep[pairs.slaves] = False
    red_of = -np.ones(n, dtype=np.int64)
    red_of[keep] = np.arange(keep.sum())
    nr = int(keep.sum())
    bbox_center = (points2d.min(0) + points2d.max(0)) / 2.0
    center_node = int(np.argmin(np.linalg.norm(points2d - bbox_center, axis=1)))
    center_red = red_of[master_of[center_node]]

    rows, cols = [], []
    for comp in range(2):
        for node in range(n):
            rows.append(comp * n + node)
            cols.append(comp * nr + red_of[master_of[node]])
    P_red = sp.coo_matrix(
        (np.ones(len(rows)), (rows, cols)), shape=(2 * n, 2 * nr)
    ).tocsr()
    pinned = np.array([center_red, nr + center_red])
    free = np.setdiff1d(np.arange(2 * nr), pinned)

    dofs = np.concatenate([tris, tris + n], axis=1)  # (F, 6) component-major

    def deformation_gradient(u: np.ndarray) -> np.ndarray:
        u2 = np.stack([u[:n], u[n:]], axis=1)  # component-major → (N, 2)
        ue = u2[tris]  # (F, 3, 2)
        dudX = np.einsum("fid,fig->fdg", ue, grads)
        F = dudX.copy()
        F[:, 0, 0] += 1.0
        F[:, 1, 1] += 1.0
        return F

    def residual(u: np.ndarray) -> np.ndarray:
        F = deformation_gradient(u)
        P = piola_stress(F)
        # R_a,d = Σ_e A_e P_dg ∂N_a/∂X_g
        Re = np.einsum("f,fdg,fag->fad", areas, P, grads)  # (F, 3, 2)
        R = np.zeros(2 * n)
        np.add.at(R, dofs, Re.transpose(0, 2, 1).reshape(len(tris), 6))
        return R

    def tangent(u: np.ndarray) -> sp.csr_matrix:
        F = deformation_gradient(u)
        dPdF = _element_tangent(F)  # (F,2,2,2,2)
        # K_(a,d),(b,e) = A ∂N_a/∂X_g dP_dg/dF_eh ∂N_b/∂X_h
        Ke = np.einsum(
            "f,fag,fdgeh,fbh->fadbe", areas, grads, dPdF, grads
        )  # (F,3,2,3,2)
        # local dof order [ux1..3, uy1..3] ↔ (a,d) with d-major? component-
        # major: index = d*3 + a
        Ke = Ke.transpose(0, 2, 1, 4, 3).reshape(len(tris), 6, 6)
        r = np.repeat(dofs, 6, axis=1).ravel()
        c = np.tile(dofs, (1, 6)).ravel()
        return sp.coo_matrix(
            (Ke.ravel(), (r, c)), shape=(2 * n, 2 * n)
        ).tocsr()

    def affine_field(G: np.ndarray) -> np.ndarray:
        const = np.zeros((n, 2))
        const[pairs.slaves] = pairs.shifts @ G.T
        c_full = np.zeros(2 * n)
        c_full[:n] = const[:, 0]
        c_full[n:] = const[:, 1]
        return c_full

    # incremental loading
    u = np.zeros(2 * n)
    t = 0.0
    step = dt
    consecutive_ok = 0
    while t < 1.0 - 1e-12:
        step = min(step, 1.0 - t)
        G_t = (t + step) * G_target
        c_full = affine_field(G_t)
        # warm start: carry the fluctuation (reduced coords of current u);
        # the affine part enters through the updated constraint constants
        u_red = np.zeros(2 * nr)
        u_red[: nr] = u[:n][keep]
        u_red[nr:] = u[n:][keep]
        converged = False
        norm0 = None
        for it in range(max_iter):
            u_full = P_red @ u_red + c_full
            R = residual(u_full)
            R_red = P_red.T @ R
            R_free = R_red[free]
            norm = np.linalg.norm(R_free)
            if not np.isfinite(norm):
                break
            if norm0 is None:
                # fedoo's err0=None: normalize by the step's initial
                # residual (`generate_dataset_hyperelast.py:328`)
                norm0 = norm
                if norm0 == 0.0:
                    converged = True
                    break
            elif norm / norm0 < tol:
                converged = True
                break
            K = tangent(u_full)
            K_red = (P_red.T @ K @ P_red).tocsr()
            K_ff = K_red[free][:, free]
            try:
                du = spla.spsolve(K_ff.tocsc(), -R_free)
            except Exception:
                break
            if not np.all(np.isfinite(du)):
                break
            u_red[free] += du
        if converged:
            u = P_red @ u_red + c_full
            t += step
            consecutive_ok += 1
            if consecutive_ok >= 2:  # update_dt=True growth
                step = min(step * 1.5, 0.2)
        else:
            consecutive_ok = 0
            step /= 2.0
            if step < dt_min:
                raise RuntimeError(
                    f"Newton-Raphson did not converge (t={t:.3f})"
                )

    F = deformation_gradient(u)
    sigma_e = cauchy_stress(F)  # (F, 2, 2)
    stress_e = np.stack(
        [sigma_e[:, 0, 0], sigma_e[:, 1, 1], sigma_e[:, 0, 1]], axis=1
    )
    # strain: Green-Lagrange in-plane, Voigt [Exx, Eyy, 2Exy]
    Egl = 0.5 * (np.einsum("fki,fkj->fij", F, F) - np.eye(2))
    strain_e = np.stack(
        [Egl[:, 0, 0], Egl[:, 1, 1], 2 * Egl[:, 0, 1]], axis=1
    )
    g2n = gausspoint_to_node_matrix(points2d, tris)
    stress_n = g2n @ stress_e
    strain_n = g2n @ strain_e

    F_bar = np.eye(2) + G_target
    det_F = np.linalg.det(F_bar)  # λ3 = 1
    box = points2d.max(0) - points2d.min(0)
    deformed_volume = float(box[0] * box[1]) * det_F

    def integrate_nodal(f: np.ndarray) -> np.ndarray:
        elem_mean = f[tris].mean(axis=1)
        return np.einsum("f,f...->...", areas, elem_mean)

    v_mat = float(integrate_nodal(np.ones(n)))
    mean_stress = integrate_nodal(stress_n) / deformed_volume
    mean_stress_mat = integrate_nodal(stress_n) / (v_mat * det_F)

    disp = np.stack([u[:n], u[n:]], axis=1)
    return FEMResult(
        displacement=disp,
        stress_nodes=stress_n,
        strain_nodes=strain_n,
        stress_elems=stress_e,
        mean_stress=np.asarray(mean_stress),
        mean_stress_material=np.asarray(mean_stress_mat),
    )


def deformed_op_div_matrix(
    points2d: np.ndarray, tris: np.ndarray, displacement: np.ndarray
) -> sp.coo_matrix:
    """Divergence operator on the DEFORMED configuration
    (`generate_dataset_hyperelast.py:352`)."""
    from p_div_gnn_tpu_torch.datagen.opdiv import compute_op_div_matrix

    return compute_op_div_matrix(points2d + displacement, tris)
