"""Command-line entry points of the port (argparse).

The counterparts of the JAX package's commands (``p_div_gnn_tpu/cli.py``),
installed as ``pdg-torch-<command>`` or run as ``python -m
p_div_gnn_tpu_torch.cli <command> ...``:

    pdg-torch-train --config_path cfg.yml [--resume] [--device cpu]
    pdg-torch-infer --config_path cfg.yml [--device cpu]
    pdg-torch-generate --dataset_path DIR [--n_samples 1000]
        [--test_size 0.25] [--seed 69] [--max_workers N] [--hyperelastic]
        [--bc dirichlet|neumann] [--element tri|quad]
    pdg-torch-benchmark [--csv_data_filename data.csv] [--hyperelastic]
        [--output_folder benchmark_results] [--steps 20] [--device cpu]
    pdg-torch-compare --dataset_csv test.csv --inference_folders A [B ...]
        [--model_names a b ...] [--figures_folder DIR] [--topk K]
    pdg-torch-scaling [--graphs_per_device 4] [--latent_size 128]
        [--message_passing_steps 10] [--output rows.json] [--device cpu]

The commands that use a device run on the card unless ``--device`` names
another; ``generate`` and ``compare`` run on the host only (numpy, scipy),
as in the JAX package, and take no ``--device``. Data-parallel training
over N cards (a config with ``data_parallel: True``): ``torchrun
--nproc-per-node N -m p_div_gnn_tpu_torch.cli train --config_path
cfg.yml``. The JAX CLI's fp32 fused ``PDG_EDGE_BLOCK=512`` switch is a TPU
VMEM limit and has no counterpart.
"""

from __future__ import annotations

import argparse
import sys
import time

def train_main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(prog="pdg-torch-train")
    p.add_argument("--config_path", required=True)
    p.add_argument(
        "--resume", action="store_true",
        help="resume from the run's last-epoch checkpoint (overrides the config's "
        "resume key)",
    )
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = p.parse_args(argv)
    from p_div_gnn_tpu_torch.train.runner import main

    main(args.config_path, resume_override=True if args.resume else None, device=args.device)


def infer_main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(prog="pdg-torch-infer")
    p.add_argument("--config_path", required=True)
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = p.parse_args(argv)
    from p_div_gnn_tpu_torch.inference import main

    main(args.config_path, device=args.device)


def generate_main(argv: list[str] | None = None) -> None:
    """Generate a dataset (host only: meshing and FEM in a process pool)."""
    p = argparse.ArgumentParser(prog="pdg-torch-generate")
    p.add_argument("--n_samples", type=int, default=1000)
    p.add_argument("--test_size", type=float, default=0.25)
    p.add_argument("--seed", type=int, default=69)
    p.add_argument("--dataset_path", required=True)
    p.add_argument("--max_workers", type=int, default=None)
    p.add_argument("--hyperelastic", action="store_true",
                   help="Neo-Hookean finite-strain dataset")
    p.add_argument("--bc", choices=("dirichlet", "neumann"), default="dirichlet",
                   help="elastic BC mode: strain-controlled or stress-controlled")
    p.add_argument("--element", choices=("tri", "quad"), default="tri",
                   help="element type: P1 triangles or Q4 quads")
    args = p.parse_args(argv)
    t0 = time.perf_counter()
    from p_div_gnn_tpu_torch.datagen.generate import main

    main(n_samples=args.n_samples, test_size=args.test_size, seed=args.seed,
         dataset_path=args.dataset_path, max_workers=args.max_workers,
         hyperelastic=args.hyperelastic, bc=args.bc, element=args.element)
    print(f"Data generated in {time.perf_counter() - t0:9.4f} seconds")


def benchmark_main(argv: list[str] | None = None) -> None:
    """The GNN-vs-FEM wall-time sweep (the GNN on ``--device``, the FEM on
    the host), or a replot of its CSV."""
    p = argparse.ArgumentParser(prog="pdg-torch-benchmark")
    p.add_argument("--csv_data_filename", default=None)
    p.add_argument("--hyperelastic", action="store_true")
    p.add_argument("--output_folder", default="benchmark_results")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = p.parse_args(argv)
    from p_div_gnn_tpu_torch.analysis.benchmark import main

    main(csv_data_filename=args.csv_data_filename, hyperelastic=args.hyperelastic,
         output_folder=args.output_folder, steps=args.steps, device=args.device)


def compare_main(argv: list[str] | None = None) -> dict:
    """Per-model metrics of inference folders against the ground truth
    (host only); returns ``analysis.compare.main``'s per-sample tables by
    model name."""
    p = argparse.ArgumentParser(prog="pdg-torch-compare")
    p.add_argument("--dataset_csv", required=True)
    p.add_argument("--inference_folders", nargs="+", required=True,
                   help="one or more inference result folders (each with dataset.csv)")
    p.add_argument("--model_names", nargs="+", default=None)
    p.add_argument("--figures_folder", default=None)
    p.add_argument("--topk", type=int, default=0)
    args = p.parse_args(argv)
    from p_div_gnn_tpu_torch.analysis.compare import main

    return main(dataset_csv=args.dataset_csv, inference_folders=args.inference_folders,
                model_names=args.model_names, figures_folder=args.figures_folder,
                topk=args.topk)


def scaling_main(argv: list[str] | None = None) -> None:
    """Data-parallel weak-scaling report: the train step at 1, 2, 4, 8
    cards (up to those present), each carrying ``--graphs_per_device``
    plate-with-hole meshes."""
    p = argparse.ArgumentParser(prog="pdg-torch-scaling")
    p.add_argument("--graphs_per_device", type=int, default=4)
    p.add_argument("--latent_size", type=int, default=128)
    p.add_argument("--message_passing_steps", type=int, default=10)
    p.add_argument("--output", default=None)
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = p.parse_args(argv)
    import json

    import numpy as np

    from p_div_gnn_tpu_torch.datagen.mesher import hole_plate_mesh
    from p_div_gnn_tpu_torch.datagen.opdiv import compute_op_div_matrix
    from p_div_gnn_tpu_torch.graphs.batching import GraphSample
    from p_div_gnn_tpu_torch.graphs.build import mesh_to_graph
    from p_div_gnn_tpu_torch.graphs.labels import compute_node_labels
    from p_div_gnn_tpu_torch.graphs.periodic import compute_periodic_graph
    from p_div_gnn_tpu_torch.parallel.scaling import measure_dp_scaling

    rng = np.random.default_rng(0)
    samples = []
    for i in range(args.graphs_per_device):
        mesh = hole_plate_mesh(100.0, 100.0, radius=20.0, hole_center=(50.0, 50.0),
                               hole_refinement_factor=6.0, global_mesh_refinement_size=4.0,
                               seed=i)
        g = compute_periodic_graph(mesh_to_graph(mesh))
        op = compute_op_div_matrix(mesh.points[:, :2], mesh.faces)
        samples.append(GraphSample(
            graph=g,
            mean_stress=rng.normal(size=3).astype(np.float32),
            local_stress=rng.normal(size=(g.num_nodes, 3)).astype(np.float32),
            node_labels=compute_node_labels(mesh),
            div_data=op.data.astype(np.float32),
            div_row=op.row.astype(np.int64),
            div_col=op.col.astype(np.int64),
        ))
    rows = measure_dp_scaling(samples, latent_size=args.latent_size,
                              message_passing_steps=args.message_passing_steps,
                              device=args.device)
    for r in rows:
        print(f"devices={r['devices']:2d}  step={r['step_s'] * 1e3:8.2f} ms  "
              f"{r['edges_per_s'] / 1e6:8.3f} M edges/s  "
              f"efficiency={r['efficiency'] * 100:6.1f}%")
    if args.output:
        with open(args.output, "w") as fh:
            json.dump(rows, fh, indent=2)


def main(argv: list[str]) -> int:
    """``python -m p_div_gnn_tpu_torch.cli <command> ...``; returns the exit
    code."""
    dispatch = {"train": train_main, "infer": infer_main, "generate": generate_main,
                "benchmark": benchmark_main, "compare": compare_main, "scaling": scaling_main}
    cmd = argv[0] if argv else ""
    if cmd not in dispatch:
        print(f"usage: python -m p_div_gnn_tpu_torch.cli {{{'|'.join(dispatch)}}} ...",
              file=sys.stderr)
        return 2
    dispatch[cmd](argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
