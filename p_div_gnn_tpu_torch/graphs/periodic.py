"""Periodic boundary edge construction.

Copy of ``p_div_gnn_tpu/graphs/periodic.py`` (the native C++ library of
``graphs/native.py`` when it is available, else numpy), the twin of
the reference's `compute_periodic_graph` (`datasets.py:39-119`): matches
left↔right and lower↔upper boundary nodes of a rectangular RVE, adds crossed
corner links, gives all new edges weight 0, and coalesces.
"""

from __future__ import annotations

import numpy as np

from p_div_gnn_tpu_torch.graphs.build import MeshGraph, coalesce_edges


def periodic_boundary_pairs(points_2d: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Return (extra_senders, extra_receivers) for periodic boundary links.

    Matching uses exact coordinate equality against the bounding box, like
    the reference (`datasets.py:44-47`); side node lists are ordered by
    lexsort with y as the primary key and x secondary (`datasets.py:49-63`).
    """
    from p_div_gnn_tpu_torch.graphs import native

    fast = native.periodic_pairs(points_2d)
    if fast is not None:
        return fast
    min_x, min_y = points_2d.min(axis=0)
    max_x, max_y = points_2d.max(axis=0)
    idx = np.arange(len(points_2d))

    def side(mask: np.ndarray) -> np.ndarray:
        sel = idx[mask]
        order = np.lexsort((points_2d[sel, 0], points_2d[sel, 1]))
        return sel[order]

    left = side(points_2d[:, 0] == min_x)
    right = side(points_2d[:, 0] == max_x)
    lower = side(points_2d[:, 1] == min_y)
    upper = side(points_2d[:, 1] == max_y)
    if len(left) != len(right) or len(lower) != len(upper):
        raise ValueError("opposite boundary node counts differ: mesh is not periodic")

    def corner(x: float, y: float) -> int:
        hit = idx[(points_2d[:, 0] == x) & (points_2d[:, 1] == y)]
        if len(hit) != 1:
            raise ValueError(f"expected exactly one corner node at ({x},{y})")
        return int(hit[0])

    # Order: [ll, lu, rl, ru]; crossed with its flip ([ru, rl, lu, ll]),
    # giving ll↔ru and lu↔rl diagonal links (`datasets.py:64-85,105`).
    corners = np.array(
        [
            corner(min_x, min_y),
            corner(min_x, max_y),
            corner(max_x, min_y),
            corner(max_x, max_y),
        ]
    )
    senders = np.concatenate([left, right, lower, upper, corners])
    receivers = np.concatenate([right, left, upper, lower, corners[::-1]])
    return senders, receivers


def compute_periodic_graph(graph: MeshGraph) -> MeshGraph:
    """Augment a mesh graph with periodic boundary edges (weight 0)."""
    points_2d = np.asarray(graph.pos[:, :2], dtype=np.float64)
    senders, receivers = periodic_boundary_pairs(points_2d)
    n_row = np.concatenate([graph.edge_index[0], senders])
    n_col = np.concatenate([graph.edge_index[1], receivers])
    edge_attr = np.zeros(len(n_row), dtype=np.float32)
    edge_attr[: graph.num_edges] = graph.edge_weight
    edge_index, edge_attr = coalesce_edges(
        np.stack([n_row, n_col]), edge_attr, graph.num_nodes
    )
    return MeshGraph(
        pos=graph.pos,
        edge_index=edge_index,
        edge_weight=edge_attr.astype(np.float32),
        faces=graph.faces,
        org_num_edges=graph.num_edges,
        is_periodic=True,
    )
