"""Node labeling: INTERNAL / EXTERNAL_BOUNDARY / INTERNAL_BOUNDARY.

Copy of ``p_div_gnn_tpu/graphs/labels.py`` (the native C++ library of
``graphs/native.py`` when it is available, else numpy), the twin of
the reference's `compute_node_labels` (`datasets.py:122-179`): boundary edges
are mesh edges incident to exactly one cell; connected components of the
boundary-edge graph give the regions; the region touching the bounding box
is the external boundary.
"""

from __future__ import annotations

from enum import IntEnum

import numpy as np

from p_div_gnn_tpu_torch.graphs.meshio import SurfaceMesh


class NodeType(IntEnum):
    INTERNAL_BOUNDARY = -1
    INTERNAL = 0
    EXTERNAL_BOUNDARY = 1


def boundary_edges(faces: np.ndarray) -> np.ndarray:
    """Undirected edges belonging to exactly one cell, shape (B, 2)."""
    faces = np.asarray(faces, dtype=np.int64)
    k = faces.shape[1]
    pairs = np.concatenate(
        [np.stack([faces[:, i], faces[:, (i + 1) % k]], axis=1) for i in range(k)]
    )
    pairs.sort(axis=1)
    uniq, counts = np.unique(pairs, axis=0, return_counts=True)
    return uniq[counts == 1]


def _connected_components(edges: np.ndarray, num_nodes: int) -> np.ndarray:
    """Union-find over an edge list; returns component id per node (-1 for
    nodes not in any edge)."""
    parent = np.arange(num_nodes)

    def find(a: int) -> int:
        root = a
        while parent[root] != root:
            root = parent[root]
        while parent[a] != root:
            parent[a], a = root, parent[a]
        return root

    for a, b in edges:
        ra, rb = find(int(a)), find(int(b))
        if ra != rb:
            parent[rb] = ra
    comp = np.full(num_nodes, -1, dtype=np.int64)
    roots: dict[int, int] = {}
    for n in np.unique(edges):
        comp[n] = roots.setdefault(find(int(n)), len(roots))
    return comp


def compute_node_labels(mesh: SurfaceMesh) -> np.ndarray:
    """Label each node per NodeType; requires exactly 2 boundary regions
    (plate outline + hole), as the reference does (`datasets.py:153-156`)."""
    from p_div_gnn_tpu_torch.graphs import native

    fast = native.compute_node_labels(mesh.faces, mesh.points[:, :2])
    if fast is not None:
        return fast
    comp = _connected_components(boundary_edges(mesh.faces), mesh.n_points)
    region_ids = [r for r in np.unique(comp) if r >= 0]
    if len(region_ids) != 2:
        raise ValueError(
            f"Expected 2 regions, found {len(region_ids)} for the given mesh"
        )

    min_x, max_x, min_y, max_y = mesh.bounds2d()
    pts = mesh.points[:, :2]

    def touches_bounds(region: int) -> bool:
        p = pts[comp == region]
        return bool(
            np.any(
                (p[:, 0] == min_x)
                | (p[:, 0] == max_x)
                | (p[:, 1] == min_y)
                | (p[:, 1] == max_y)
            )
        )

    external = region_ids[0] if touches_bounds(region_ids[0]) else region_ids[1]
    internal = region_ids[1] if external == region_ids[0] else region_ids[0]

    labels = np.full(mesh.n_points, int(NodeType.INTERNAL), dtype=np.int64)
    labels[comp == external] = int(NodeType.EXTERNAL_BOUNDARY)
    labels[comp == internal] = int(NodeType.INTERNAL_BOUNDARY)
    return labels


def von_mises_stress(sx: np.ndarray, sy: np.ndarray, sxy: np.ndarray) -> np.ndarray:
    """Von Mises from 2D components (`datasets.py:216-229`)."""
    return np.sqrt(0.5 * ((sx - sy) ** 2 + sx**2 + sy**2 + 6 * sxy**2))
