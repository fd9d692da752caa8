"""GNN-vs-FEM wall-time benchmark: the counterpart of
``p_div_gnn_tpu/analysis/benchmark.py`` (the ``benchmark`` command).

It sweeps the hole-refinement factor over ``linspace(1, 100, steps)`` (a
mesh-size sweep) and times, per mesh:

- (a) the GNN forward alone, on a batch already on the device;
- (b) the GNN with the mesh → graph and periodic-edge preprocessing and the
  host → device copy;
- (c) the FEM solve on the host (numpy / scipy; a failed Neo-Hookean solve
  reports 0).

Each GNN time is bracketed by ``torch.cuda.synchronize()`` on the card. One
warm-up per shape comes first, and each time is the mean over
``n_mean_steps`` random loadings. The model is random-init, latent 128 and
10 message-passing steps, on the plain ``"xla"`` path, as the JAX package's
benchmark is (``scatter_impl`` left at its default): this path launches
none of the hand-written kernels. ``main`` writes ``benchmark_data.csv``
(columns ``n_nodes, hole_refinement_factor, gnn_gpu, gnn_gpu_prepro,
fem``) and then draws the log-scale plot; without matplotlib (the card's
machine has none) it fails at the plot, after the CSV is written.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from p_div_gnn_tpu_torch.utils.configio import Table, read_csv, write_csv

COLUMNS = ("n_nodes", "hole_refinement_factor", "gnn_gpu", "gnn_gpu_prepro", "fem")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def benchmark_gnn(
    model: Any, stats: Any, batch: Any, use_preprocessing: bool,
    rebuild: Callable[[], Any], device: torch.device,
) -> float:
    """Synced wall time of one forward; with ``use_preprocessing`` the
    batch is rebuilt from the mesh and copied to the device inside the
    timing."""
    _sync(device)
    t0 = time.perf_counter()
    if use_preprocessing:
        batch = rebuild().to(device)
    with torch.no_grad():
        model(batch, stats, scale_input=True, scale_output=True)
    _sync(device)
    return time.perf_counter() - t0


def benchmark_fem(points2d: np.ndarray, tris: np.ndarray,
                  strains: np.ndarray, hyperelastic: bool) -> float:
    t0 = time.perf_counter()
    if hyperelastic:
        from p_div_gnn_tpu_torch.datagen.hyperelastic import (
            solve_periodic_rve_neohookean,
        )

        try:
            solve_periodic_rve_neohookean(points2d, tris, *strains)
        except Exception:
            return 0.0  # a failed solve reports 0, as the JAX package's
    else:
        from p_div_gnn_tpu_torch.datagen.fem import solve_periodic_rve

        solve_periodic_rve(points2d, tris, *strains)
    return time.perf_counter() - t0


def sweep(
    hyperelastic: bool = False,
    steps: int = 20,
    n_mean_steps: int = 5,
    device: str | torch.device = "cuda",
    verbose: bool = True,
) -> list[dict[str, float]]:
    """The benchmark's rows, one per hole-refinement factor (``COLUMNS``;
    times in seconds)."""
    from p_div_gnn_tpu_torch.datagen.mesher import hole_plate_mesh
    from p_div_gnn_tpu_torch.graphs.batching import GraphSample, pack_batch
    from p_div_gnn_tpu_torch.graphs.build import mesh_to_graph
    from p_div_gnn_tpu_torch.graphs.container import NormStats
    from p_div_gnn_tpu_torch.graphs.labels import compute_node_labels
    from p_div_gnn_tpu_torch.graphs.periodic import compute_periodic_graph
    from p_div_gnn_tpu_torch.models.epd import EncodeProcessDecode

    device = torch.device(device)
    seed = 69
    rng = np.random.default_rng(seed=seed)
    strain_range = (-0.15, 0.15) if hyperelastic else (-0.05, 0.05)
    model = EncodeProcessDecode(latent_size=128, message_passing_steps=10,
                                generator=torch.Generator().manual_seed(0))
    model.to(device).eval()
    stats = NormStats.ones()

    rows = []
    for factor in np.linspace(1, 100, steps):
        mesh = hole_plate_mesh(
            100.0, 100.0, radius=30.0, hole_center=(50.0, 50.0),
            hole_refinement_factor=float(factor),
            global_mesh_refinement_size=5.0, seed=seed,
        )
        pts = mesh.points[:, :2]
        labels = compute_node_labels(mesh)

        def build_batch():
            g = compute_periodic_graph(mesh_to_graph(mesh))
            n = g.num_nodes
            s = GraphSample(
                graph=g,
                mean_stress=rng.normal(size=3).astype(np.float32),
                local_stress=np.zeros((n, 3), np.float32),
                node_labels=labels,
                div_data=np.zeros(1, np.float32),
                div_row=np.zeros(1, np.int64),
                div_col=np.zeros(1, np.int64),
            )
            return pack_batch([s], n_graphs=1, reorder="rcm")

        batch = build_batch().to(device)
        # one warm-up per shape
        benchmark_gnn(model, stats, batch, False, build_batch, device)
        strains = rng.uniform(*strain_range, size=3)
        benchmark_fem(pts, mesh.faces, strains, hyperelastic)

        t_gnn, t_gnn_pre, t_fem = [], [], []
        for _ in range(n_mean_steps):
            strains = rng.uniform(*strain_range, size=3)
            t_fem.append(benchmark_fem(pts, mesh.faces, strains, hyperelastic))
            t_gnn.append(benchmark_gnn(model, stats, batch, False, build_batch, device))
            t_gnn_pre.append(benchmark_gnn(model, stats, batch, True, build_batch, device))
        rows.append(
            {
                "n_nodes": mesh.n_points,
                "hole_refinement_factor": float(factor),
                "gnn_gpu": float(np.mean(t_gnn)),
                "gnn_gpu_prepro": float(np.mean(t_gnn_pre)),
                "fem": float(np.mean(t_fem)),
            }
        )
        if verbose:
            print(
                f"factor {factor:6.1f}: N={mesh.n_points:6d} "
                f"gnn={rows[-1]['gnn_gpu']*1e3:7.2f}ms "
                f"gnn+pre={rows[-1]['gnn_gpu_prepro']*1e3:7.2f}ms "
                f"fem={rows[-1]['fem']*1e3:8.2f}ms"
            )
    return rows


def main(
    csv_data_filename: str | None = None,
    hyperelastic: bool = False,
    output_folder: str = "benchmark_results",
    steps: int = 20,
    n_mean_steps: int = 5,
    device: str | torch.device = "cuda",
) -> None:
    """Sweep on ``device`` and write ``benchmark_data.csv`` and
    ``benchmark.pdf`` under ``output_folder``; with ``csv_data_filename``,
    replot that CSV without a sweep."""
    out = Path(output_folder)
    out.mkdir(parents=True, exist_ok=True)
    if csv_data_filename:
        plot(read_csv(csv_data_filename), out / "benchmark.pdf", hyperelastic)
        return
    rows = sweep(hyperelastic, steps, n_mean_steps, device)
    data = {k: [r[k] for r in rows] for k in COLUMNS}
    write_csv(out / "benchmark_data.csv", data)
    plot(data, out / "benchmark.pdf", hyperelastic)


def plot(data: Table, output_file: str | Path, hyperelastic: bool) -> None:
    """Log-scale wall-time plot of the benchmark's table."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.style.use("seaborn-v0_8-whitegrid")
    fig, ax = plt.subplots(figsize=(7, 5))
    ax.plot(data["n_nodes"], data["gnn_gpu"], label="GNN (GPU)", color="C0",
            marker="o")
    ax.plot(
        data["n_nodes"], data["gnn_gpu_prepro"],
        label="GNN with Periodic Edges (GPU)", color="C1", marker="s",
    )
    ax.plot(data["n_nodes"], data["fem"], label="FEM", color="C3", marker="^")
    ax.set_xlabel("Number of nodes")
    ax.set_ylabel("Time [s]")
    ax.set_yscale("log")
    kind = (
        "Non linear hyper-elasticity" if hyperelastic else "Linear elasticity"
    )
    ax.set_title(f"Computation Time vs. Number of Nodes ({kind})")
    ax.grid(True, which="both", ls="--", linewidth=0.5)
    ax.legend()
    fig.tight_layout()
    fig.savefig(output_file)
    plt.close(fig)
