"""Hold the fused3 edge step's kernels of this checkout against another
checkout's on the card, bit for bit: for example against the parent commit,
unpacked with ``git archive`` into a directory that .gitignore lists.

    python3 scripts/port_tree_compare.py --other build/parent [--require bwd]

Each tree runs in a process of its own, from its own root: it builds its
forward (``csrc/fused_edge3_fwd.cu``) and backward (``fused_edge3_bwd.cu``)
kernels, packs the benchmark's training batch (16 meshes, seed 0) and draws
seeded random inputs on the card (as chip_smoke.py's kernel phases do:
x, e ~ N(0, 1), g_x = x[senders], weights ~ N(0, 1/L), biases and the
cotangents ~ N(0, 1)), then runs the forward and, on the plain version's
z_upd, the backward, in fp32 and bf16 streams, and writes a SHA-256 of each
output's bytes to ``build/port_tree_compare/``. This process prints, per
output, whether the two trees agree, and exits 1 if an output whose name
starts with one of ``--require`` (default: bwd) differs. Needs one CUDA card
and nvcc; it imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "port_tree_compare"


def worker(out: Path) -> None:
    """Run in the tree at the current directory; write the output hashes."""
    sys.path.insert(0, os.getcwd())
    import torch

    from p_div_gnn_tpu_torch.datagen.workload import build_workload
    from p_div_gnn_tpu_torch.ops import fused_edge3

    batch = build_workload(16, seed=0)[0].to("cuda")
    Np, Ep, L = batch.num_nodes_padded, batch.num_edges_padded, 128
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape: int, scale: float = 1.0) -> torch.Tensor:
        return torch.randn(shape, generator=gen, device="cuda") * scale

    x = randn(Np, L)
    base = [x, x.index_select(0, batch.senders), randn(Ep, L),
            *(randn(L, L, scale=L**-0.5) for _ in range(3)), randn(L),
            randn(L, L, scale=L**-0.5), randn(L)]
    dz, dr, dm = randn(Ep, L), randn(Np, L), randn(8, L)
    aux = (batch.edge_gid, batch.edge_block_tile)
    hashes = {}

    def put(name: str, t: torch.Tensor) -> None:
        hashes[name] = hashlib.sha256(t.detach().contiguous().cpu().view(torch.uint8)
                                      .numpy().tobytes()).hexdigest()

    for sd_name, sd in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        args = [t.to(sd).contiguous() for t in base]
        fwd = fused_edge3.fused_edge_step3(*args, batch.receivers, aux, batch.n_graphs,
                                           batch.tile)
        for name, t in zip(("z_upd", "R", "M"), fwd):
            put(f"fwd {sd_name} {name}", t)
        z_upd = fused_edge3.fused_edge_step3_reference(*args, batch.receivers, batch.edge_gid,
                                                       batch.n_graphs)[0]
        bwd = fused_edge3.fused_edge_step3_backward(
            *args, batch.receivers, aux, batch.n_graphs, batch.tile, z_upd, dz.to(sd), dr, dm)
        for name, t in zip(("dx", "dg", "de", "dWu", "dWv", "dWe", "db0", "dW2", "db2"), bwd):
            put(f"bwd {sd_name} {name}", t)
        del fwd, bwd, z_upd
        torch.cuda.empty_cache()
    out.write_text(json.dumps(hashes, indent=1))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, help="root of the other checkout")
    ap.add_argument("--require", nargs="*", default=["bwd"],
                    help="output name prefixes that must be bit-equal")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker)
        return 0
    OUT.mkdir(parents=True, exist_ok=True)
    runs = {}
    for label, tree in (("this", ROOT), ("other", args.other.resolve())):
        out = OUT / f"{label}.json"
        subprocess.run([sys.executable, str(Path(__file__).resolve()), "--worker", str(out)],
                       cwd=tree, check=True)
        runs[label] = json.loads(out.read_text())
    bad = []
    for name, h in runs["this"].items():
        same = runs["other"].get(name) == h
        print(f"{name}: {'bit-equal' if same else 'differs'}", flush=True)
        if not same and any(name.startswith(p) for p in args.require):
            bad.append(name)
    if bad:
        print(f"port_tree_compare: required outputs differ: {bad}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
