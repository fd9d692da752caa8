"""The benchmark's mesh pool, made by the frozen generators.

Every seed gets the same meshes in the same order: n hole radii
stratified over the traffic's range, mesh i meshed with its own fixed
jitter, so the work of a run does not depend on its seed (the seed draws
the macroscopic stresses, the targets and the weights). Meshes are built
in spawned worker processes (the caller may hold threads and a CUDA
context, which a fork must not copy), joined before the pool is returned.
Where the caller names a cache folder, the built pool is kept there under
a hash of its spec and of the generators' sources, so that only a
checkout's first run meshes it.
"""

from __future__ import annotations

import hashlib
import json
import multiprocessing
import os
import pickle
from pathlib import Path

import numpy as np

from perfbench.inputs.graph import divergence_operator, node_labels, periodic_graph
from perfbench.inputs.mesher import hole_plate_mesh

THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def one_mesh(spec: dict, radius: float, mesh_seed: list[int], with_div: bool) -> dict:
    """One plate-with-hole mesh with its periodic graph, node labels and,
    with ``with_div``, its divergence operator's COO entries."""
    width, height = spec["plate"]
    points, faces = hole_plate_mesh(
        width, height, radius=radius, hole_center=(width / 2, height / 2),
        hole_refinement_factor=spec["hole_refinement_factor"],
        global_mesh_refinement_size=spec["global_mesh_refinement_size"],
        seed=mesh_seed,
    )
    mesh = periodic_graph(points, faces)
    mesh.update(points=points, faces=faces, labels=node_labels(points, faces), radius=radius)
    if with_div:
        op = divergence_operator(points[:, :2], faces)
        mesh.update(div_data=op.data.astype(np.float32), div_row=op.row.astype(np.int64),
                    div_col=op.col.astype(np.int64))
    return mesh


def _job(args: tuple) -> dict:
    return one_mesh(*args)


def pool_meshes(spec: dict) -> list[tuple[float, list[int]]]:
    """(radius, mesher seed) of each mesh of the pool: n radii stratified
    over [lo, hi), mesh i jittered by [1, i]."""
    n = spec["meshes"]
    lo, hi = spec["radius"]
    return [(float(lo + (hi - lo) * (i + 0.5) / n), [1, i]) for i in range(n)]


def cache_file(spec: dict, folder: Path) -> Path:
    """The pool's file in ``folder``: named by a hash of the spec and of
    the sources of the generators that build it."""
    digest = hashlib.sha256(json.dumps(spec, sort_keys=True).encode())
    for name in ("pool.py", "mesher.py", "graph.py"):
        digest.update((Path(__file__).parent / name).read_bytes())
    return Path(folder) / f"pool-{digest.hexdigest()[:16]}.pkl"


class PoolBuilder:
    """The pool of ``spec["meshes"]`` meshes (with the divergence operator
    where ``spec["divergence_operator"]``), built by ``workers`` spawned
    processes while the caller goes on; ``result()`` waits for it in pool
    order, ``close()`` stops the workers. One worker builds in the calling
    process. With ``cache``, a pool kept there is read instead, and a pool
    built is kept there."""

    def __init__(self, spec: dict, workers: int | None = None, cache: Path | None = None):
        with_div = bool(spec.get("divergence_operator", False))
        self.jobs = [(spec, r, mesh_seed, with_div) for r, mesh_seed in pool_meshes(spec)]
        self.workers = workers or min(6, os.cpu_count() or 1)
        self.pool = self.pending = None
        self.file = cache_file(spec, cache) if cache is not None else None
        if self.file is not None and self.file.is_file():
            self.workers = 0
        elif self.workers > 1:
            # one thread a worker: the workers share the host's cores
            saved = {k: os.environ.get(k) for k in THREAD_VARS}
            os.environ.update({k: "1" for k in THREAD_VARS})
            try:
                self.pool = multiprocessing.get_context("spawn").Pool(self.workers)
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
            self.pending = self.pool.map_async(_job, self.jobs, chunksize=1)

    def result(self) -> list[dict]:
        if self.workers == 0:
            return pickle.loads(self.file.read_bytes())
        if self.pool is None:
            meshes = [_job(j) for j in self.jobs]
        else:
            try:
                meshes = self.pending.get()
            except BaseException:
                self.close()
                raise
            self.pool.close()
            self.pool.join()
            self.pool = None
        if self.file is not None:
            self.file.parent.mkdir(parents=True, exist_ok=True)
            partial = self.file.with_suffix(".partial")
            partial.write_bytes(pickle.dumps(meshes, protocol=pickle.HIGHEST_PROTOCOL))
            partial.replace(self.file)
        return meshes

    def close(self) -> None:
        if self.pool is not None:
            self.pool.terminate()
            self.pool.join()
            self.pool = None


def build_pool(spec: dict, workers: int | None = None) -> list[dict]:
    """The pool, in pool order (``PoolBuilder``, waited for)."""
    return PoolBuilder(spec, workers).result()


def sine_targets(pool: list[dict], seed: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """(mean stress (3,), stress field (N, 3)) per mesh: the mean stress
    drawn N(0, 1), the field ``mean · (1 + 0.2 sin(x / 20))``, a target the
    model can learn."""
    rng = np.random.default_rng([seed, 2])
    out = []
    for mesh in pool:
        mean = rng.normal(size=3)
        field = mean[None, :] * (1.0 + 0.2 * np.sin(mesh["points"][:, :1] / 20.0))
        out.append((mean.astype(np.float32), field.astype(np.float32)))
    return out
