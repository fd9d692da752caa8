"""Dataset loading: CSV rows → GraphSamples + dataset normalization stats.

The counterpart of ``p_div_gnn_tpu/graphs/dataset.py:26-138`` over the
port's CSV table (``utils/configio.read_csv``: {column: values}) in place of
a DataFrame. Per row: read the mesh, build the (optionally periodic) graph
with distance edge weights, attach the macroscopic mean stress, the target
stress field, the divergence operator's COO entries and the node labels;
then the dataset-wide scalar mean / std of pos, mean_stress, local_stress
and edge_weight (unbiased std, ``ddof=1``; mean_stress weighted by node
count, as the reference broadcasts it per node).
"""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from p_div_gnn_tpu_torch.graphs.batching import GraphSample
from p_div_gnn_tpu_torch.graphs.build import mesh_to_graph
from p_div_gnn_tpu_torch.graphs.container import NormStats
from p_div_gnn_tpu_torch.graphs.labels import von_mises_stress
from p_div_gnn_tpu_torch.graphs.meshio import load_sample_npz, read_vtk
from p_div_gnn_tpu_torch.graphs.periodic import compute_periodic_graph
from p_div_gnn_tpu_torch.utils.configio import Table

# below this many rows a process pool costs more than it saves
POOL_MIN_ROWS = 64


def load_sample(
    mesh_filename: str,
    data_filename: str,
    periodic_graph: bool = True,
    mesh_id: int = -1,
) -> GraphSample:
    mesh = read_vtk(mesh_filename)
    graph = mesh_to_graph(mesh)
    if periodic_graph:
        graph = compute_periodic_graph(graph)
    data = load_sample_npz(data_filename)
    mean_stress = np.asarray(data["mean_stress"], np.float32)
    return GraphSample(
        graph=graph,
        mean_stress=mean_stress,
        local_stress=np.asarray(data["stress_field"], np.float32),
        node_labels=np.asarray(data["node_labels"], np.int64),
        div_data=np.asarray(data["op_div_matrix_data"], np.float32),
        div_row=np.asarray(data["op_div_matrix_row_indices"], np.int64),
        div_col=np.asarray(data["op_div_matrix_col_indices"], np.int64),
        von_mises=float(von_mises_stress(*mean_stress)),
        mesh_id=mesh_id,
    )


def _load_sample_job(args: tuple) -> GraphSample:
    mesh_fn, data_fn, periodic, i = args
    return load_sample(mesh_fn, data_fn, periodic, mesh_id=i)


class MeshStressFieldDataset:
    """In-memory dataset over a ``dataset.csv`` table.

    From ``POOL_MIN_ROWS`` rows on, loading runs in a process pool of
    ``PDG_LOAD_WORKERS`` workers (default: the CPU count; ``0`` or ``1``
    loads serially), in row order. Its workers are spawned, never forked:
    the caller may already hold a CUDA context, which a forked child must
    not touch.
    """

    def __init__(self, table: Table, periodic_graph: bool = True):
        self.table = table
        self.periodic_graph = periodic_graph
        jobs = [(m, d, periodic_graph, i) for i, (m, d) in
                enumerate(zip(table["mesh_filename"], table["data_filename"]))]
        workers = int(os.environ.get("PDG_LOAD_WORKERS", os.cpu_count() or 1))
        if workers > 1 and len(jobs) >= POOL_MIN_ROWS:
            with ProcessPoolExecutor(
                max_workers=workers, mp_context=multiprocessing.get_context("spawn")
            ) as pool:
                self.samples = list(pool.map(_load_sample_job, jobs, chunksize=64))
        else:
            self.samples = [_load_sample_job(job) for job in jobs]
        self.stats = compute_norm_stats(self.samples)

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, i: int) -> GraphSample:
        return self.samples[i]


def compute_norm_stats(samples: list[GraphSample]) -> NormStats:
    """Scalar mean / std over the concatenated tensors (`datasets.py:284-291`):
    mean_stress over its per-node broadcast, pos over the (N, 2) coordinates,
    std unbiased (torch's ``.std()``)."""
    pos = np.concatenate([s.graph.pos[:, :2].astype(np.float32) for s in samples])
    ms = np.concatenate([
        np.broadcast_to(s.mean_stress.astype(np.float32), (s.num_nodes, 3))
        for s in samples])
    ls = np.concatenate([s.local_stress.astype(np.float32) for s in samples])
    ew = np.concatenate([s.graph.edge_weight.astype(np.float32) for s in samples])

    def stat(x: np.ndarray) -> tuple[float, float]:
        return float(np.float32(x.mean())), float(np.float32(np.std(x, ddof=1)))

    (mean_pos, std_pos), (mean_ms, std_ms), (mean_ls, std_ls), (mean_ew, std_ew) = (
        stat(pos), stat(ms), stat(ls), stat(ew))
    return NormStats(mean_pos, std_pos, mean_ms, std_ms, mean_ls, std_ls, mean_ew, std_ew)
