"""The icosahedral mesh hierarchy on the unit sphere and its multimesh, as
GraphCast builds them (Lam et al., Science 2023, arXiv:2212.12794;
github.com/google-deepmind/graphcast ``icosahedral_mesh.py``). It has no
counterpart in the JAX package.

- Level 0 is the regular icosahedron with the published orientation: the
  vertices ``(±1, ±φ, 0)``, ``(0, ±1, ±φ)``, ``(±φ, 0, ±1)`` on the unit
  sphere, rotated about the y axis by half the supplement of the dihedral
  angle, so that a face, not an edge, lies at each pole. Its 20 faces are
  the vertex triples that are pairwise neighbours, each ordered
  anticlockwise seen from outside.
- Level k + 1 splits every face of level k into four at its sides'
  midpoints, pushed out onto the sphere: face ``(a, b, c)`` becomes ``(a,
  ab, ca)``, ``(ab, b, bc)``, ``(ca, bc, c)``, ``(ab, bc, ca)``, children
  ``4f .. 4f + 3`` of face f. A level keeps its parent's vertices first
  and appends one vertex a side, so level k holds ``10·4^k + 2`` vertices,
  ``20·4^k`` faces and ``30·4^k`` sides.
- ``faces_to_edges`` gives a face's three directed sides, ``a→b``, ``b→c``,
  ``c→a``: each side of a closed, consistently oriented mesh once in each
  direction. The multimesh is the union of the chosen levels' sides over
  the finest level's vertices.

Vertices are numbered in another order than the published builder's (new
vertices by sorted side, not by first use); the graphs are the same up to
that renumbering, which the model does not see.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

PHI = (1.0 + np.sqrt(5.0)) / 2.0


@dataclass(frozen=True)
class TriangularMesh:
    vertices: np.ndarray  # (V, 3) f64 on the unit sphere
    faces: np.ndarray  # (F, 3) i64, anticlockwise seen from outside


def _rotation_y(angle: float) -> np.ndarray:
    """The matrix of a rotation by ``angle`` about the y axis."""
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def icosahedron() -> TriangularMesh:
    """Level 0 in the published orientation (``get_icosahedron``): the
    vertices right-multiplied by the y rotation by (π − dihedral angle) / 2."""
    vertices = []
    for c1 in (1.0, -1.0):
        for c2 in (PHI, -PHI):
            vertices += [(c1, c2, 0.0), (0.0, c1, c2), (c2, 0.0, c1)]
    v = np.array(vertices) / np.linalg.norm([1.0, PHI])
    dihedral = 2.0 * np.arcsin(PHI / np.sqrt(3.0))
    v = v @ _rotation_y((np.pi - dihedral) / 2.0)
    d = np.linalg.norm(v[:, None] - v[None], axis=-1)
    near = np.isclose(d, d[d > 1e-9].min())
    faces = [(i, j, k) for i in range(12) for j in range(i + 1, 12) if near[i, j]
             for k in range(j + 1, 12) if near[i, k] and near[j, k]]
    f = np.array(faces, np.int64)
    outward = np.einsum("fi,fi->f", np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]]),
                        v[f[:, 0]]) > 0
    f[~outward] = f[~outward][:, [0, 2, 1]]
    return TriangularMesh(v, f)


def refine(mesh: TriangularMesh) -> TriangularMesh:
    """The next level: each face split in four at its sides' midpoints
    (the module docstring's order), the new vertices after the old ones."""
    f, n = mesh.faces, len(mesh.vertices)
    sides = np.stack([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], axis=1)  # (F, 3, 2)
    keys = np.sort(sides, axis=-1).reshape(-1, 2)
    unique, inverse = np.unique(keys, axis=0, return_inverse=True)
    mid = mesh.vertices[unique[:, 0]] + mesh.vertices[unique[:, 1]]
    vertices = np.concatenate([mesh.vertices, mid / np.linalg.norm(mid, axis=1, keepdims=True)])
    ab, bc, ca = (n + inverse.reshape(-1, 3)).T
    a, b, c = f.T
    children = np.stack([np.stack([a, ab, ca], 1), np.stack([ab, b, bc], 1),
                         np.stack([ca, bc, c], 1), np.stack([ab, bc, ca], 1)], axis=1)
    return TriangularMesh(vertices, children.reshape(-1, 3))


def hierarchy(finest: int) -> list[TriangularMesh]:
    """Levels 0 .. ``finest``; level k's vertices are the first ``10·4^k + 2``
    of every finer level's."""
    meshes = [icosahedron()]
    for _ in range(finest):
        meshes.append(refine(meshes[-1]))
    return meshes


def faces_to_edges(faces: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(senders, receivers) of the faces' directed sides a→b, b→c, c→a."""
    return (np.concatenate([faces[:, 0], faces[:, 1], faces[:, 2]]),
            np.concatenate([faces[:, 1], faces[:, 2], faces[:, 0]]))


def multimesh_edges(meshes: list[TriangularMesh],
                    levels: list[int]) -> tuple[np.ndarray, np.ndarray]:
    """(senders, receivers) of the multimesh: the directed sides of each of
    ``levels``, together, over the finest level's vertices."""
    pairs = [faces_to_edges(meshes[k].faces) for k in levels]
    return (np.concatenate([s for s, _ in pairs]), np.concatenate([r for _, r in pairs]))


def longest_side(mesh: TriangularMesh) -> float:
    """The longest chord between two neighbouring vertices of ``mesh``."""
    s, r = faces_to_edges(mesh.faces)
    return float(np.linalg.norm(mesh.vertices[s] - mesh.vertices[r], axis=1).max())
