"""Command-line entry points of the port (argparse).

The counterparts of the JAX package's ``pdg-train`` and ``pdg-infer``
(``p_div_gnn_tpu/cli.py:24``, ``:61``), installed as ``pdg-torch-train`` and
``pdg-torch-infer``, or run as ``python -m p_div_gnn_tpu_torch.cli
{train|infer} ...``:

    pdg-torch-train --config_path cfg.yml [--resume] [--device cpu]
    pdg-torch-infer --config_path cfg.yml [--device cpu]

Both run on the card unless ``--device`` names another. The JAX CLI's
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
    "scaling": "A8 (parallel/scaling.py)",
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


def main(argv: list[str]) -> int:
    """``python -m p_div_gnn_tpu_torch.cli <command> ...``; returns the exit
    code."""
    dispatch = {"train": train_main, "infer": infer_main}
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
