"""Command-line entry points of the port (argparse).

The counterparts of the JAX package's ``pdg-train`` and ``pdg-infer``
(``p_div_gnn_tpu/cli.py:24``, ``:61``), installed as ``pdg-torch-train`` and
``pdg-torch-infer``, and of ``pdg-scaling`` (``:160``) as
``pdg-torch-scaling``, or run as ``python -m p_div_gnn_tpu_torch.cli
{train|infer|scaling} ...``:

    pdg-torch-train --config_path cfg.yml [--resume] [--device cpu]
    pdg-torch-infer --config_path cfg.yml [--device cpu]
    pdg-torch-scaling [--graphs_per_device 4] [--latent_size 128]
        [--message_passing_steps 10] [--output rows.json] [--device cpu]

All run on the card unless ``--device`` names another. Data-parallel
training over N cards (a config with ``data_parallel: True``):
``torchrun --nproc-per-node N -m p_div_gnn_tpu_torch.cli train
--config_path cfg.yml``. The JAX CLI's
fp32 fused ``PDG_EDGE_BLOCK=512`` switch is a TPU VMEM limit and has no
counterpart. Its other commands are not ported yet: ``python -m`` with one
of them exits 2 with the ROADMAP item that ports it.
"""

from __future__ import annotations

import argparse
import sys

NOT_PORTED = {
    "generate": "A7 (datagen/generate.py)",
    "benchmark": "A9 (analysis/benchmark.py)",
    "compare": "A9 (analysis/compare.py)",
}


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
    dispatch = {"train": train_main, "infer": infer_main, "scaling": scaling_main}
    cmd = argv[0] if argv else ""
    if cmd in NOT_PORTED:
        print(f"{cmd!r} is not ported to p_div_gnn_tpu_torch yet: ROADMAP {NOT_PORTED[cmd]}",
              file=sys.stderr)
        return 2
    if cmd not in dispatch:
        print(f"usage: python -m p_div_gnn_tpu_torch.cli {{{'|'.join(dispatch)}}} ...",
              file=sys.stderr)
        return 2
    dispatch[cmd](argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
