"""GraphCast's graph: a latitude–longitude grid, the icosahedral multimesh,
and the two bipartite edge sets between them, with their spatial features
(Lam et al., Science 2023, arXiv:2212.12794; github.com/google-deepmind/
graphcast ``graphcast.py``, ``grid_mesh_connectivity.py`` and
``model_utils.py``). It has no counterpart in the JAX package.

- Grid nodes: every (latitude, longitude) of the grid at ``resolution``
  degrees, latitudes from −90 to 90 both poles included, longitudes from
  0, latitude-major (row i·n_lon + j is latitude i, longitude j).
- Mesh nodes: the vertices of the finest icosahedral level
  (``icosahedral.py``).
- ``mesh`` edges: the multimesh, both directions of every side of the
  chosen levels.
- ``grid2mesh`` edges: from each grid node to every mesh node within
  ``radius_fraction`` times the finest level's longest side (chords on the
  unit sphere, the distance included), found on ``device`` in chunks of
  grid nodes.
- ``mesh2grid`` edges: from the three vertices of the finest face whose cone
  from the sphere's centre holds a grid node to that node, found by
  descending the hierarchy (a face's cone is the union of its four
  children's). A node on a side or a vertex (within ``TIE`` of a cone's
  boundary) lies in several faces: it goes to the one whose centroid lies
  farthest along ``TIE_DIRECTION``, a rule of geometry alone, so that any
  builder picks the same face (the published code takes the face that
  trimesh's closest-point query returns).
- Node features (``node_features``): the cosine of the polar angle (the
  sine of the latitude, 1 at the north pole) and the cosine and sine of the
  longitude, as ``get_graph_spatial_features`` with node latitude and
  longitude on.
- Edge features (``edge_features``): the sender's position less the
  receiver's, both rotated into the receiver's frame (the receiver at
  (1, 0, 0): the components radial, east, north), and its length, all over
  the edge set's longest length: ``[|d|, d]``.
"""

from __future__ import annotations

import numpy as np
import torch

from p_div_gnn_tpu_torch.graphs import icosahedral
from p_div_gnn_tpu_torch.graphs.container import NODE_TILE
from p_div_gnn_tpu_torch.graphs.typed import NodeSet, TypedGraph, layout_edges, padded_size

RADIUS_CHUNK = 4096  # grid nodes a chunk of the radius query
TIE = 1e-9  # a cone coordinate this far below 0 still holds the point
TIE_DIRECTION = np.array([1.0, 2.0, 3.0])  # faces that share a point: the farthest along this


def lat_lon_grid(resolution: float) -> tuple[np.ndarray, np.ndarray]:
    """(latitudes, longitudes) in degrees: −90 .. 90 and 0 .. 360 − res."""
    n_lat, n_lon = round(180 / resolution) + 1, round(360 / resolution)
    return np.linspace(-90.0, 90.0, n_lat), np.arange(n_lon) * resolution


def grid_nodes(lat: np.ndarray, lon: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Each grid node's (latitude, longitude), latitude-major."""
    return np.repeat(lat, len(lon)), np.tile(lon, len(lat))


def to_xyz(lat: np.ndarray, lon: np.ndarray) -> np.ndarray:
    """(N, 3) points on the unit sphere."""
    theta, phi = np.deg2rad(90.0 - lat), np.deg2rad(lon)
    return np.stack([np.cos(phi) * np.sin(theta), np.sin(phi) * np.sin(theta), np.cos(theta)],
                    axis=1)


def to_lat_lon(xyz: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(latitudes, longitudes in [0, 360)) in degrees of unit vectors."""
    lat = 90.0 - np.rad2deg(np.arccos(np.clip(xyz[:, 2], -1.0, 1.0)))
    return lat, np.mod(np.rad2deg(np.arctan2(xyz[:, 1], xyz[:, 0])), 360.0)


def node_features(lat: np.ndarray, lon: np.ndarray) -> np.ndarray:
    """(N, 3) ``[cos θ, cos φ, sin φ]``, θ the polar angle, φ the longitude."""
    theta, phi = np.deg2rad(90.0 - lat), np.deg2rad(lon)
    return np.stack([np.cos(theta), np.cos(phi), np.sin(phi)], axis=1)


def _to_local(lat: np.ndarray, lon: np.ndarray) -> np.ndarray:
    """(N, 3, 3) rotations into each point's frame: about z by −φ, then
    about y by π/2 − θ (``get_rotation_matrices_to_local_coordinates``)."""
    a, b = -np.deg2rad(lon), np.pi / 2 - np.deg2rad(90.0 - lat)
    ca, sa, cb, sb = np.cos(a), np.sin(a), np.cos(b), np.sin(b)
    z, o = np.zeros_like(a), np.ones_like(a)
    rz = np.stack([np.stack([ca, -sa, z], -1), np.stack([sa, ca, z], -1),
                   np.stack([z, z, o], -1)], -2)
    ry = np.stack([np.stack([cb, z, sb], -1), np.stack([z, o, z], -1),
                   np.stack([-sb, z, cb], -1)], -2)
    return ry @ rz


def edge_features(s_lat: np.ndarray, s_lon: np.ndarray, r_lat: np.ndarray, r_lon: np.ndarray,
                  senders: np.ndarray, receivers: np.ndarray) -> np.ndarray:
    """(E, 4) ``[|d|, d] / max |d|``, d the sender less the receiver in the
    receiver's frame (the module docstring)."""
    rot = _to_local(r_lat, r_lon)[receivers]
    d = np.einsum("eij,ej->ei", rot, to_xyz(s_lat, s_lon)[senders]
                  - to_xyz(r_lat, r_lon)[receivers])
    length = np.linalg.norm(d, axis=1, keepdims=True)
    return np.concatenate([length, d], axis=1) / length.max()


def radius_query(points: np.ndarray, centres: np.ndarray, radius: float,
                 device: str | torch.device = "cpu") -> tuple[np.ndarray, np.ndarray]:
    """(point, centre) index pairs at most ``radius`` apart, by point, then
    centre; computed in fp64 on ``device``, ``RADIUS_CHUNK`` points a pass."""
    c = torch.as_tensor(centres, dtype=torch.float64, device=device)
    c2 = (c * c).sum(1)
    out_p, out_c = [], []
    for start in range(0, len(points), RADIUS_CHUNK):
        p = torch.as_tensor(points[start:start + RADIUS_CHUNK], dtype=torch.float64,
                            device=device)
        d2 = (p * p).sum(1)[:, None] + c2[None, :] - 2.0 * (p @ c.T)
        i, j = torch.nonzero(d2 <= radius * radius, as_tuple=True)
        out_p.append((i + start).cpu().numpy())
        out_c.append(j.cpu().numpy())
    return np.concatenate(out_p), np.concatenate(out_c)


def _cone_coordinates(mesh: icosahedral.TriangularMesh, faces: np.ndarray,
                      points: np.ndarray) -> np.ndarray:
    """(P, K, 3) coordinates of each point in the cones of its K candidate
    ``faces`` (P, K): ``p = Σ c_k v_k`` over the face's vertices."""
    m = np.swapaxes(mesh.vertices[mesh.faces[faces]], -1, -2)  # (P, K, 3, 3): columns a, b, c
    b = np.broadcast_to(points[:, None, :, None], m.shape[:-1] + (1,))
    return np.linalg.solve(m, b)[..., 0]


def containing_faces(meshes: list[icosahedral.TriangularMesh], points: np.ndarray) -> np.ndarray:
    """(P,) the index of the finest level's face whose cone holds each
    point: at each level, of the candidates (all 20 faces, then the chosen
    face's 4 children), the one whose least cone coordinate is largest;
    then, of the finest faces that share a vertex with it and hold the
    point within ``TIE``, the one farthest along ``TIE_DIRECTION``."""
    cand = np.broadcast_to(np.arange(len(meshes[0].faces)), (len(points), len(meshes[0].faces)))
    for level, mesh in enumerate(meshes):
        if level:
            cand = 4 * face[:, None] + np.arange(4)
        least = _cone_coordinates(mesh, cand, points).min(axis=2)
        face = cand[np.arange(len(points)), least.argmax(axis=1)]
    finest = meshes[-1]
    # each vertex's faces (5 or 6), the 5-face vertices' list padded by repeating one
    flat = finest.faces.reshape(-1)
    order = np.argsort(flat, kind="stable")
    by_vertex = order // 3
    starts = np.searchsorted(flat[order], np.arange(len(finest.vertices)))
    counts = np.diff(np.append(starts, len(by_vertex)))
    ring = by_vertex[starts[:, None] + np.minimum(np.arange(6), counts[:, None] - 1)]
    cand = ring[finest.faces[face]].reshape(len(points), -1)  # (P, 18)
    holds = _cone_coordinates(finest, cand, points).min(axis=2) >= -TIE
    along = finest.vertices[finest.faces[cand]].sum(axis=2) @ TIE_DIRECTION
    return cand[np.arange(len(points)), np.where(holds, along, -np.inf).argmax(axis=1)]


def grid_mesh_graph(resolution: float, mesh_levels: list[int], radius_fraction: float,
                    tile: int = NODE_TILE, device: str | torch.device = "cpu") -> TypedGraph:
    """GraphCast's typed graph on the host: node sets ``grid`` and ``mesh``,
    edge sets ``grid2mesh``, ``mesh`` and ``mesh2grid``, each with its
    features (the module docstring); the radius query runs on ``device``."""
    meshes = icosahedral.hierarchy(max(mesh_levels))
    finest = meshes[-1]
    g_lat, g_lon = grid_nodes(*lat_lon_grid(resolution))
    m_lat, m_lon = to_lat_lon(finest.vertices)
    nodes = {}
    for name, lat, lon in (("grid", g_lat, g_lon), ("mesh", m_lat, m_lon)):
        n_padded = padded_size(len(lat), tile)
        feats = np.zeros((n_padded, 3), np.float32)
        feats[:len(lat)] = node_features(lat, lon)
        nodes[name] = NodeSet(len(lat), n_padded, lat, lon, feats)
    grid_xyz = to_xyz(g_lat, g_lon)
    radius = radius_fraction * icosahedral.longest_side(finest)
    g2m_grid, g2m_mesh = radius_query(grid_xyz, finest.vertices, radius, device)
    m2g_mesh = finest.faces[containing_faces(meshes, grid_xyz)].reshape(-1)
    m2g_grid = np.repeat(np.arange(len(g_lat)), 3)
    mm_s, mm_r = icosahedral.multimesh_edges(meshes, mesh_levels)
    sets = {"grid2mesh": ("grid", "mesh", g2m_grid, g2m_mesh),
            "mesh": ("mesh", "mesh", mm_s, mm_r),
            "mesh2grid": ("mesh", "grid", m2g_mesh, m2g_grid)}
    edges = {}
    for name, (s_set, r_set, snd, rcv) in sets.items():
        s, r = nodes[s_set], nodes[r_set]
        feats = edge_features(s.lat, s.lon, r.lat, r.lon, snd, rcv)
        edges[name] = layout_edges(snd, rcv, feats, nodes, s_set, r_set, tile)
    return TypedGraph(nodes, edges)
