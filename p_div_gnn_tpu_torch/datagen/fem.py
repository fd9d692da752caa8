"""Element geometry and the gauss-point → node projection of the P1/Q4 FEM
— the subset of ``p_div_gnn_tpu/datagen/fem.py`` (``triangle_geometry``,
``quad_geometry``, ``element_geometry``, ``gausspoint_to_node_matrix``)
that the divergence operator needs, in numpy + scipy. The periodic FEM
solver itself is not ported.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


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
    bilinear Q4 elements: grads (F, 4, 2), areas (F,)."""
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


def gausspoint_to_node_matrix(
    points: np.ndarray, tris: np.ndarray
) -> sp.csr_matrix:
    """Area-weighted projection of per-element (1 gauss pt) values to nodes:
    node value = Σ_e A_e v_e / Σ_e A_e over incident elements. Element-type
    agnostic (P1 triangles or Q4 quads)."""
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
