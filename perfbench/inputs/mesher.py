"""The plate-with-hole mesher, frozen: a copy of the port's
``datagen/mesher.py::hole_plate_mesh`` (P1 triangles, periodic boundaries
by construction) that returns ``(points (N, 3), faces (F, 3))`` in place of
the port's ``SurfaceMesh``. The benchmark's meshes come from here, so a
change to the program's mesher cannot move the yardstick.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import Delaunay, cKDTree


def _size_field(
    pts: np.ndarray,
    center: np.ndarray,
    radius: float,
    h_hole: float,
    h_far: float,
    growth: float = 0.35,
) -> np.ndarray:
    d = np.linalg.norm(pts - center, axis=-1) - radius
    return np.clip(h_hole + growth * np.maximum(d, 0.0), h_hole, h_far)


def hole_plate_mesh(
    width: float,
    height: float,
    radius: float,
    hole_center: tuple[float, float],
    hole_refinement_factor: float = 10.0,
    global_mesh_refinement_size: float = 10.0,
    seed: int = 0,
    smooth_iters: int = 3,
) -> tuple[np.ndarray, np.ndarray]:
    h_far = float(global_mesh_refinement_size)
    h_hole = h_far / float(hole_refinement_factor)
    cx, cy = hole_center
    center = np.array([cx, cy])
    rng = np.random.default_rng(seed)

    # --- boundary points (identical subdivisions on opposite sides →
    # periodic by construction)
    nb_x = max(2, int(round(width / h_far)))
    nb_y = max(2, int(round(height / h_far)))
    xs = np.linspace(0.0, width, nb_x + 1)
    ys = np.linspace(0.0, height, nb_y + 1)
    bottom = np.stack([xs, np.zeros_like(xs)], 1)
    top = np.stack([xs, np.full_like(xs, height)], 1)
    left = np.stack([np.zeros_like(ys[1:-1]), ys[1:-1]], 1)
    right = np.stack([np.full_like(ys[1:-1], width), ys[1:-1]], 1)
    square = np.concatenate([bottom, top, left, right])

    # --- circle points at hole spacing
    n_c = max(12, int(round(2 * np.pi * radius / h_hole)))
    theta = np.arange(n_c) * (2 * np.pi / n_c)
    circle = center + radius * np.stack([np.cos(theta), np.sin(theta)], 1)

    fixed = np.concatenate([square, circle])

    # --- interior candidates: one jittered stratified grid per size level
    levels = []
    h = h_hole
    while h < h_far:
        levels.append(h)
        h *= 1.9
    levels.append(h_far)
    cands = []
    for h in levels:
        nx = max(1, int(width / h))
        ny = max(1, int(height / h))
        gx, gy = np.meshgrid(
            (np.arange(nx) + 0.5) * (width / nx),
            (np.arange(ny) + 0.5) * (height / ny),
        )
        p = np.stack([gx.ravel(), gy.ravel()], 1)
        p = p + rng.uniform(-0.25, 0.25, p.shape) * h
        target = _size_field(p, center, radius, h_hole, h_far)
        # keep candidates whose local target size matches this level
        lo, hi = h / 1.9, h * 1.35
        sel = (target >= lo) & (target <= hi)
        cands.append(p[sel])
    pts = np.concatenate(cands) if cands else np.zeros((0, 2))

    # inside plate, outside hole (with margin), away from square boundary
    margin = 0.45 * h_hole
    d_hole = np.linalg.norm(pts - center, axis=1)
    h_loc = _size_field(pts, center, radius, h_hole, h_far)
    keep = (
        (d_hole > radius + margin + 0.35 * h_loc)
        & (pts[:, 0] > 0.45 * h_loc)
        & (pts[:, 0] < width - 0.45 * h_loc)
        & (pts[:, 1] > 0.45 * h_loc)
        & (pts[:, 1] < height - 0.45 * h_loc)
    )
    pts = pts[keep]

    # --- prune: no candidate closer than 0.62·h(p) to a fixed point or an
    # earlier-accepted candidate (greedy, kd-tree batched)
    tree_fixed = cKDTree(fixed)
    h_loc = _size_field(pts, center, radius, h_hole, h_far)
    d_fixed, _ = tree_fixed.query(pts, k=1)
    pts = pts[d_fixed > 0.75 * h_loc]
    h_loc = _size_field(pts, center, radius, h_hole, h_far)
    order = np.argsort(h_loc)  # finest first
    pts, h_loc = pts[order], h_loc[order]
    accepted_idx: list[int] = []
    if len(pts):
        tree = cKDTree(pts)
        taken = np.zeros(len(pts), dtype=bool)
        removed = np.zeros(len(pts), dtype=bool)
        for i in range(len(pts)):
            if removed[i]:
                continue
            taken[i] = True
            accepted_idx.append(i)
            for j in tree.query_ball_point(pts[i], 0.62 * h_loc[i]):
                if j != i and not taken[j]:
                    removed[j] = True
    interior = pts[accepted_idx] if accepted_idx else np.zeros((0, 2))

    points = np.concatenate([fixed, interior])
    n_fixed = len(fixed)

    # --- triangulate + carve hole + smooth
    def triangulate(p: np.ndarray) -> np.ndarray:
        tri = Delaunay(p)
        simplices = tri.simplices
        cent = p[simplices].mean(axis=1)
        outside_hole = np.linalg.norm(cent - center, axis=1) > radius
        t = simplices[outside_hole]
        # enforce CCW orientation
        v1 = p[t[:, 1]] - p[t[:, 0]]
        v2 = p[t[:, 2]] - p[t[:, 0]]
        area2 = v1[:, 0] * v2[:, 1] - v1[:, 1] * v2[:, 0]
        flip = area2 < 0
        t[flip] = t[flip][:, [0, 2, 1]]
        return t

    tris = triangulate(points)
    for _ in range(smooth_iters):
        # Laplacian smoothing of interior points over current triangulation
        nbr_sum = np.zeros_like(points)
        nbr_cnt = np.zeros(len(points))
        for a, b in ((0, 1), (1, 2), (2, 0)):
            np.add.at(nbr_sum, tris[:, a], points[tris[:, b]])
            np.add.at(nbr_cnt, tris[:, a], 1.0)
            np.add.at(nbr_sum, tris[:, b], points[tris[:, a]])
            np.add.at(nbr_cnt, tris[:, b], 1.0)
        avg = nbr_sum / np.maximum(nbr_cnt, 1.0)[:, None]
        points[n_fixed:] = avg[n_fixed:]
        # project any point that drifted into the hole back to the circle
        d = np.linalg.norm(points[n_fixed:] - center, axis=1)
        bad = d < radius + 0.3 * h_hole
        if np.any(bad):
            p_bad = points[n_fixed:][bad]
            dirs = (p_bad - center) / np.maximum(d[bad], 1e-12)[:, None]
            points[n_fixed:][bad] = center + dirs * (radius + 0.6 * h_hole)
        tris = triangulate(points)

    # drop unreferenced points (can happen after pruning near the hole)
    used = np.unique(tris)
    remap = -np.ones(len(points), dtype=np.int64)
    remap[used] = np.arange(len(used))
    points = points[used]
    tris = remap[tris]

    pts3 = np.concatenate([points, np.zeros((len(points), 1))], axis=1)
    return pts3, tris.astype(np.int64)
