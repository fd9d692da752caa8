"""The flagship training workload — the port's home for
``bench.py::build_workload`` (``bench.py:95-138``), which is a script and
not a module of the JAX package.

16 periodic plate-with-hole meshes (``hole_plate_mesh`` at global size 2.5,
hole refinement 8, radius drawn in [15, 30)), each with its divergence
operator, random macroscopic and local stresses, packed with RCM node
ordering, the sender-major view and the gather-only divergence views: the
batch the benchmark's training step runs on (receiver-major, or
pair-blocked for the ``fused2`` path, ``bench.py:95-96, :134``). Everything
comes from ``numpy.random.default_rng(seed)``, in the benchmark's order.
"""

from __future__ import annotations

import numpy as np

from p_div_gnn_tpu_torch.datagen.mesher import hole_plate_mesh
from p_div_gnn_tpu_torch.datagen.opdiv import compute_op_div_matrix
from p_div_gnn_tpu_torch.graphs.batching import GraphSample, pack_batch
from p_div_gnn_tpu_torch.graphs.build import mesh_to_graph
from p_div_gnn_tpu_torch.graphs.container import GraphBatch
from p_div_gnn_tpu_torch.graphs.labels import compute_node_labels
from p_div_gnn_tpu_torch.graphs.periodic import compute_periodic_graph


def build_samples(
    n_graphs: int = 16, seed: int = 0, div_operator: bool = True
) -> list[GraphSample]:
    """The benchmark's meshes as host samples; ``div_operator=False`` leaves
    the divergence operator out (serving does not read it) and draws the
    same meshes and stresses."""
    rng = np.random.default_rng(seed)
    samples = []
    for i in range(n_graphs):
        mesh = hole_plate_mesh(
            100.0, 100.0,
            radius=float(rng.uniform(15, 30)),
            hole_center=(50.0, 50.0),
            hole_refinement_factor=8.0,
            global_mesh_refinement_size=2.5,
            seed=seed + i,
        )
        g = compute_periodic_graph(mesh_to_graph(mesh))
        if div_operator:
            op = compute_op_div_matrix(mesh.points[:, :2], mesh.faces)
            div = (op.data.astype(np.float32), op.row.astype(np.int64),
                   op.col.astype(np.int64))
        else:
            div = (np.zeros(0, np.float32), np.zeros(0, np.int64), np.zeros(0, np.int64))
        n = g.num_nodes
        samples.append(
            GraphSample(
                graph=g,
                mean_stress=rng.normal(size=3).astype(np.float32),
                local_stress=rng.normal(size=(n, 3)).astype(np.float32),
                node_labels=compute_node_labels(mesh),
                div_data=div[0],
                div_row=div[1],
                div_col=div[2],
            )
        )
    return samples


def pack_workload(
    samples: list[GraphSample], pair_blocks: bool = False
) -> tuple[GraphBatch, int, int]:
    """(host batch, real edges, real nodes) of the benchmark's training step
    on ``samples``: RCM-ordered, with the sender view and the divergence ELL
    views; pair-blocked with ``pair_blocks``."""
    batch = pack_batch(samples, n_graphs=len(samples), pair_blocks=pair_blocks,
                       reorder="rcm")
    n_real_edges = sum(s.num_edges for s in samples)
    n_real_nodes = sum(s.num_nodes for s in samples)
    return batch, n_real_edges, n_real_nodes


def build_workload(
    n_graphs: int = 16, seed: int = 0, pair_blocks: bool = False
) -> tuple[GraphBatch, int, int]:
    """(host batch, real edges, real nodes) of the benchmark's training
    step (``bench.py::build_workload``)."""
    return pack_workload(build_samples(n_graphs, seed), pair_blocks)
