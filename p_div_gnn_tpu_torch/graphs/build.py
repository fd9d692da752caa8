"""Host-side mesh→graph construction (numpy).

Copy of ``p_div_gnn_tpu/graphs/build.py`` (the reference's
`convert_utils.py:47-81` and `datasets.py:182-188`): the edge index comes
from the native C++ library (``graphs/native.py``) when it is available,
else from the numpy path, which stays the behavioral reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from p_div_gnn_tpu_torch.graphs.meshio import SurfaceMesh


@dataclasses.dataclass
class MeshGraph:
    """A single mesh graph on the host (numpy, pre-batching).

    ``edge_index`` is (2, E) with row 0 = senders (source) and row 1 =
    receivers (target), directed with both directions present, sorted
    lexicographically by (sender, receiver) — the same canonical order a
    PyG ``coalesce()`` produces (`datasets.py:113-119`).
    """

    pos: np.ndarray  # (N, 3) float
    edge_index: np.ndarray  # (2, E) int64
    edge_weight: np.ndarray  # (E,) float32 (node distances; 0 on periodic)
    faces: np.ndarray | None = None  # (F, K) int64
    org_num_edges: int | None = None  # edge count before periodic augmentation
    is_periodic: bool = False

    @property
    def num_nodes(self) -> int:
        return int(self.pos.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.edge_index.shape[1])


def coalesce_edges(
    edge_index: np.ndarray, edge_attr: np.ndarray | None, num_nodes: int
) -> tuple[np.ndarray, np.ndarray | None]:
    """Sort edges by (sender, receiver), merge duplicates (summing attrs),
    as torch_geometric ``coalesce`` does (`datasets.py:119`)."""
    keys = edge_index[0].astype(np.int64) * num_nodes + edge_index[1].astype(np.int64)
    order = np.argsort(keys, kind="stable")
    keys_sorted = keys[order]
    uniq_mask = np.ones(len(keys_sorted), dtype=bool)
    uniq_mask[1:] = keys_sorted[1:] != keys_sorted[:-1]
    uniq_keys = keys_sorted[uniq_mask]
    out_index = np.stack([uniq_keys // num_nodes, uniq_keys % num_nodes]).astype(
        np.int64
    )
    out_attr = None
    if edge_attr is not None:
        seg_ids = np.cumsum(uniq_mask) - 1
        out_attr = np.zeros(len(uniq_keys), dtype=edge_attr.dtype)
        np.add.at(out_attr, seg_ids, edge_attr[order])
    return out_index, out_attr


def faces_to_edge_index(faces: np.ndarray, num_nodes: int) -> np.ndarray:
    """Undirected (symmetrized, deduped, sorted) edge index from cells.

    Triangles use the FaceToEdge pairing (`convert_utils.py:58`); quads use
    the 4-sided pairing of `_quad_face_to_edge` (`convert_utils.py:63-81`),
    which skips the diagonals.
    """
    faces = np.asarray(faces, dtype=np.int64)
    k = faces.shape[1]
    if k == 3:
        pair_slots = [(0, 1), (1, 2), (2, 0)]
    elif k == 4:
        pair_slots = [(0, 1), (1, 2), (2, 3), (3, 0)]
    else:
        raise ValueError(f"unsupported cell arity {k}")
    from p_div_gnn_tpu_torch.graphs import native

    fast = native.faces_to_edge_index(faces, num_nodes)
    if fast is not None:
        return fast
    src = np.concatenate([faces[:, a] for a, _ in pair_slots])
    dst = np.concatenate([faces[:, b] for _, b in pair_slots])
    senders = np.concatenate([src, dst])
    receivers = np.concatenate([dst, src])
    edge_index, _ = coalesce_edges(np.stack([senders, receivers]), None, num_nodes)
    return edge_index


def edge_distances(pos: np.ndarray, edge_index: np.ndarray) -> np.ndarray:
    """Euclidean node distance per edge (`datasets.py:182-188`), on the full
    (possibly 3D, Z=0) coordinates like the reference."""
    diff = pos[edge_index[0]] - pos[edge_index[1]]
    return np.linalg.norm(diff, axis=1).astype(np.float32)


def mesh_to_graph(mesh: SurfaceMesh) -> MeshGraph:
    """Build the mesh graph with distance edge weights (C1+C4)."""
    edge_index = faces_to_edge_index(mesh.faces, mesh.n_points)
    pos = np.asarray(mesh.points, dtype=np.float64)
    return MeshGraph(
        pos=pos,
        edge_index=edge_index,
        edge_weight=edge_distances(pos, edge_index),
        faces=np.asarray(mesh.faces, dtype=np.int64),
        org_num_edges=edge_index.shape[1],
        is_periodic=False,
    )
