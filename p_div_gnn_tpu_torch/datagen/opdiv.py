"""Divergence operator assembly — the copy of
``p_div_gnn_tpu/datagen/opdiv.py`` (reference `_compute_op_div_matrix`).

D = gausspoint2node @ div_operator: for a nodal vector field v with
component-major dofs (all v_x then all v_y), the per-element (1 gauss
point) divergence is ``Σ_i (∂N_i/∂x v_x,i + ∂N_i/∂y v_y,i)``; the
area-weighted node projection then yields a (N, 2N) sparse matrix. Applied
columnwise to [(σxx;σxy), (σxy;σyy)] it gives the nodal div(σ) vectors of
the physics loss (``losses.py``).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from p_div_gnn_tpu_torch.datagen.fem import element_geometry, gausspoint_to_node_matrix


def compute_op_div_matrix(points2d: np.ndarray, tris: np.ndarray) -> sp.coo_matrix:
    """Element-type agnostic: P1 triangles (3 cols/element) or Q4 quads
    (4 cols/element, centroid gradients)."""
    n = len(points2d)
    f = len(tris)
    k = tris.shape[1]
    grads, _ = element_geometry(points2d, tris)
    # element-divergence operator: (F, 2N)
    rows = np.repeat(np.arange(f), k)
    data_x = grads[:, :, 0].ravel()
    data_y = grads[:, :, 1].ravel()
    cols_x = tris.ravel()
    cols_y = tris.ravel() + n
    Bdiv = sp.coo_matrix(
        (
            np.concatenate([data_x, data_y]),
            (np.concatenate([rows, rows]), np.concatenate([cols_x, cols_y])),
        ),
        shape=(f, 2 * n),
    ).tocsr()
    g2n = gausspoint_to_node_matrix(points2d, tris)
    return (g2n @ Bdiv).tocoo()


def compute_op_mean_stress(points2d: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Mean-over-bounding-box operator: a (N,) weight vector w with
    ``w·f = ∫f dV / V_box`` for a nodal field f, using nodal quadrature."""
    n = len(points2d)
    k = tris.shape[1]
    _, areas = element_geometry(points2d, tris)
    w = np.zeros(n)
    np.add.at(w, tris.ravel(), np.repeat(areas / k, k))
    box = points2d.max(0) - points2d.min(0)
    return w / float(box[0] * box[1])
