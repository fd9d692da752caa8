"""Mesh → periodic graph, node labels and divergence operator, frozen: the
numpy paths of the port's ``graphs/build.py`` (edges from triangles,
coalesce, distances), ``graphs/periodic.py`` (periodic boundary links),
``graphs/labels.py`` (INTERNAL / EXTERNAL_BOUNDARY / INTERNAL_BOUNDARY) and
``datagen/opdiv.py`` with ``datagen/fem.py``'s P1 geometry (the (N, 2N)
divergence operator), copied so that a change to the program cannot move
the benchmark's inputs. P1 triangles only: the benchmark's mesher makes no
other element.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

INTERNAL_BOUNDARY, INTERNAL, EXTERNAL_BOUNDARY = -1, 0, 1


def coalesce_edges(
    edge_index: np.ndarray, edge_attr: np.ndarray | None, num_nodes: int
) -> tuple[np.ndarray, np.ndarray | None]:
    """Sort edges by (sender, receiver) and merge duplicates, summing attrs."""
    keys = edge_index[0].astype(np.int64) * num_nodes + edge_index[1].astype(np.int64)
    order = np.argsort(keys, kind="stable")
    keys_sorted = keys[order]
    uniq_mask = np.ones(len(keys_sorted), dtype=bool)
    uniq_mask[1:] = keys_sorted[1:] != keys_sorted[:-1]
    uniq_keys = keys_sorted[uniq_mask]
    out_index = np.stack([uniq_keys // num_nodes, uniq_keys % num_nodes]).astype(np.int64)
    out_attr = None
    if edge_attr is not None:
        seg_ids = np.cumsum(uniq_mask) - 1
        out_attr = np.zeros(len(uniq_keys), dtype=edge_attr.dtype)
        np.add.at(out_attr, seg_ids, edge_attr[order])
    return out_index, out_attr


def faces_to_edge_index(faces: np.ndarray, num_nodes: int) -> np.ndarray:
    """Both directions of every triangle side, deduplicated and sorted."""
    faces = np.asarray(faces, dtype=np.int64)
    pair_slots = [(0, 1), (1, 2), (2, 0)]
    src = np.concatenate([faces[:, a] for a, _ in pair_slots])
    dst = np.concatenate([faces[:, b] for _, b in pair_slots])
    edge_index, _ = coalesce_edges(
        np.stack([np.concatenate([src, dst]), np.concatenate([dst, src])]), None, num_nodes)
    return edge_index


def edge_distances(pos: np.ndarray, edge_index: np.ndarray) -> np.ndarray:
    diff = pos[edge_index[0]] - pos[edge_index[1]]
    return np.linalg.norm(diff, axis=1).astype(np.float32)


def periodic_boundary_pairs(points_2d: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(senders, receivers) linking left↔right and lower↔upper boundary
    nodes (sides ordered by y, then x) and the crossed corners."""
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

    corners = np.array([corner(min_x, min_y), corner(min_x, max_y),
                        corner(max_x, min_y), corner(max_x, max_y)])
    senders = np.concatenate([left, right, lower, upper, corners])
    receivers = np.concatenate([right, left, upper, lower, corners[::-1]])
    return senders, receivers


def periodic_graph(points: np.ndarray, faces: np.ndarray) -> dict[str, np.ndarray]:
    """The mesh's edges with distance weights, plus the periodic links
    (weight 0), coalesced: ``pos`` (N, 3) f64, ``edge_index`` (2, E) i64
    sorted by (sender, receiver), ``edge_weight`` (E,) f32, and
    ``org_num_edges``, the mesh's own edge count."""
    n = len(points)
    pos = np.asarray(points, dtype=np.float64)
    mesh_edges = faces_to_edge_index(faces, n)
    weights = edge_distances(pos, mesh_edges)
    senders, receivers = periodic_boundary_pairs(pos[:, :2])
    n_row = np.concatenate([mesh_edges[0], senders])
    n_col = np.concatenate([mesh_edges[1], receivers])
    attr = np.zeros(len(n_row), dtype=np.float32)
    attr[: mesh_edges.shape[1]] = weights
    edge_index, attr = coalesce_edges(np.stack([n_row, n_col]), attr, n)
    return {"pos": pos, "edge_index": edge_index, "edge_weight": attr.astype(np.float32),
            "org_num_edges": int(mesh_edges.shape[1])}


def boundary_edges(faces: np.ndarray) -> np.ndarray:
    """Undirected edges that belong to exactly one cell, (B, 2)."""
    faces = np.asarray(faces, dtype=np.int64)
    k = faces.shape[1]
    pairs = np.concatenate(
        [np.stack([faces[:, i], faces[:, (i + 1) % k]], axis=1) for i in range(k)])
    pairs.sort(axis=1)
    uniq, counts = np.unique(pairs, axis=0, return_counts=True)
    return uniq[counts == 1]


def _connected_components(edges: np.ndarray, num_nodes: int) -> np.ndarray:
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


def node_labels(points: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Each node's type: the boundary region that touches the bounding box
    is the external boundary, the other the hole's; the rest internal."""
    n = len(points)
    comp = _connected_components(boundary_edges(faces), n)
    region_ids = [r for r in np.unique(comp) if r >= 0]
    if len(region_ids) != 2:
        raise ValueError(f"Expected 2 regions, found {len(region_ids)} for the given mesh")
    pts = points[:, :2]
    (min_x, min_y), (max_x, max_y) = pts.min(0), pts.max(0)

    def touches_bounds(region: int) -> bool:
        p = pts[comp == region]
        return bool(np.any((p[:, 0] == min_x) | (p[:, 0] == max_x)
                           | (p[:, 1] == min_y) | (p[:, 1] == max_y)))

    external = region_ids[0] if touches_bounds(region_ids[0]) else region_ids[1]
    internal = region_ids[1] if external == region_ids[0] else region_ids[0]
    labels = np.full(n, INTERNAL, dtype=np.int64)
    labels[comp == external] = EXTERNAL_BOUNDARY
    labels[comp == internal] = INTERNAL_BOUNDARY
    return labels


def _triangle_geometry(points: np.ndarray, tris: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-element shape-function gradients (F, 3, 2) and areas (F,)."""
    p = points[tris]
    v1 = p[:, 1] - p[:, 0]
    v2 = p[:, 2] - p[:, 0]
    det = v1[:, 0] * v2[:, 1] - v1[:, 1] * v2[:, 0]
    b = np.empty((len(tris), 3, 2))
    b[:, 0, 0] = p[:, 1, 1] - p[:, 2, 1]
    b[:, 1, 0] = p[:, 2, 1] - p[:, 0, 1]
    b[:, 2, 0] = p[:, 0, 1] - p[:, 1, 1]
    b[:, 0, 1] = p[:, 2, 0] - p[:, 1, 0]
    b[:, 1, 1] = p[:, 0, 0] - p[:, 2, 0]
    b[:, 2, 1] = p[:, 1, 0] - p[:, 0, 0]
    return b / det[:, None, None], det / 2.0


def divergence_operator(points2d: np.ndarray, tris: np.ndarray) -> sp.coo_matrix:
    """The (N, 2N) nodal divergence operator, component-major dofs: the
    per-element divergence projected to the nodes by area weights."""
    n, f, k = len(points2d), len(tris), tris.shape[1]
    grads, areas = _triangle_geometry(points2d, tris)
    rows = np.repeat(np.arange(f), k)
    bdiv = sp.coo_matrix(
        (np.concatenate([grads[:, :, 0].ravel(), grads[:, :, 1].ravel()]),
         (np.concatenate([rows, rows]), np.concatenate([tris.ravel(), tris.ravel() + n]))),
        shape=(f, 2 * n)).tocsr()
    m = sp.coo_matrix((np.repeat(areas, k), (tris.ravel(), np.repeat(np.arange(f), k))),
                      shape=(n, f)).tocsr()
    norm = np.asarray(m.sum(axis=1)).ravel()
    g2n = sp.diags(1.0 / np.maximum(norm, 1e-300)) @ m
    return (g2n @ bdiv).tocoo()
