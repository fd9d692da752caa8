"""Hold the fused3 edge step's kernels and the v2 and pair-blocked kernels of
this checkout against another checkout's on the card, and time them in
both: for example against the parent commit, unpacked with ``git archive``
into a directory that .gitignore lists (the port's package is all it
needs).

    git archive HEAD p_div_gnn_tpu_torch | tar -x -C build/parent
    python3 scripts/port_tree_compare.py --other build/parent [--require bwd ...]

Each tree runs in a process of its own, from its own root (this file's
worker, the tree's package): it builds its kernels, packs the benchmark's
training batch (16 meshes, seed 0) receiver-major and pair-blocked, and
draws seeded random inputs on the card (as chip_smoke.py's kernel phases
do: node rows, e ~ N(0, 1), sender gathers of the node rows, weights ~
N(0, 1/L), biases and the cotangents ~ N(0, 1)), then runs the fused3
forward and backward (#1, #2; the backward on the plain version's z_upd),
the v2 forward and backward (#5, #6) and the pair-blocked forward and
backward kernel (#7, #8), in fp32 and bf16 streams, the block-CSR segment
sum (#3) and the pair segment sum (#4, on both batches' sender views in run
order; in bf16 only where the tree's wrapper takes bf16 rows), and writes a
SHA-256 of each output's bytes and the kernels' times (CUDA events, mean of
5 calls after 2, of 50 for the segment sums, which also get their device
time from torch.profiler) to ``build/port_tree_compare/``; the first run of
the other tree also saves #5's and #7's outputs there, and each run of
this tree reports their largest absolute difference from them. The trees
run in the order other, this, this, other; this process prints, per
output, whether the two trees agree (and for #5 and #7 the largest
difference), each kernel's times in both, and exits 1 if an output whose
name starts with one of ``--require`` differs (default: every output of
#1, #2, #3 and #5-#8). Needs one CUDA card and nvcc; it imports nothing of
JAX.
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


def worker(out: Path, save: Path | None, ref: Path | None) -> None:
    """Run in the tree at the current directory; write the output hashes
    and times; save #5's and #7's outputs to ``save``, or compare them with
    those saved in ``ref``."""
    sys.path.insert(0, os.getcwd())
    import torch

    from p_div_gnn_tpu_torch.datagen.workload import build_workload
    from p_div_gnn_tpu_torch.ops import fused_edge, fused_edge3, scatter_csr

    batch = build_workload(16, seed=0)[0].to("cuda")
    pair = build_workload(16, seed=0, pair_blocks=True)[0].to("cuda")
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
    hashes, times, fwd_out = {}, {}, {}

    def put(name: str, t: torch.Tensor) -> None:
        hashes[name] = hashlib.sha256(t.detach().contiguous().cpu().view(torch.uint8)
                                      .numpy().tobytes()).hexdigest()

    def timed(name: str, fn, iters: int = 5) -> None:
        for _ in range(2):
            fn()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times[name] = start.elapsed_time(stop) / iters

    def device_timed(name: str, fn, iters: int = 50) -> None:
        """The device time of one call (its kernels and memsets, from
        torch.profiler), which the host's launch rate does not blur."""
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(e.device_time_total for e in prof.key_averages())
        times[f"{name} device"] = total / iters / 1e3

    # the v2 step's inputs on the receiver-major batch and the fused2 step's on
    # the pair-blocked one: node rows, their sender gathers, e, We, b0, W2, b2
    a_u, a_v = randn(Np, L), randn(Np, L)
    v2_base = [a_u, a_v, a_v.index_select(0, batch.senders),
               a_u.index_select(0, batch.senders), randn(Ep, L), randn(L, L, scale=L**-0.5),
               randn(L), randn(L, L, scale=L**-0.5), randn(L)]
    v2_cots = randn(Ep, L), randn(Np, L), randn(8, L)
    Np2, Ep2 = pair.num_nodes_padded, pair.num_edges_padded
    pair_base = [randn(Np2, L), randn(Np2, L), randn(Ep2, L), randn(L, L, scale=L**-0.5),
                 randn(L), randn(L, L, scale=L**-0.5), randn(L)]
    pair_cots = randn(Ep2, L), randn(Np2, L), randn(8, L)
    pair_aux = (pair.edge_gid, pair.edge_block_tile, pair.edge_block_snd_tile,
                pair.snd_run_perm, pair.snd_run_sorted, pair.snd_block_tile)

    for sd_name, sd in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        args = [t.to(sd).contiguous() for t in base]
        fwd = fused_edge3.fused_edge_step3(*args, batch.receivers, aux, batch.n_graphs,
                                           batch.tile)
        for name, t in zip(("z_upd", "R", "M"), fwd):
            put(f"fwd {sd_name} {name}", t)
        timed(f"fwd {sd_name}", lambda: fused_edge3.fused_edge_step3(
            *args, batch.receivers, aux, batch.n_graphs, batch.tile))
        z_upd = fused_edge3.fused_edge_step3_reference(*args, batch.receivers, batch.edge_gid,
                                                       batch.n_graphs)[0]
        bwd = fused_edge3.fused_edge_step3_backward(
            *args, batch.receivers, aux, batch.n_graphs, batch.tile, z_upd, dz.to(sd), dr, dm)
        for name, t in zip(("dx", "dg", "de", "dWu", "dWv", "dWe", "db0", "dW2", "db2"), bwd):
            put(f"bwd {sd_name} {name}", t)
        timed(f"bwd {sd_name}", lambda: fused_edge3.fused_edge_step3_backward(
            *args, batch.receivers, aux, batch.n_graphs, batch.tile, z_upd, dz.to(sd), dr, dm))
        del fwd, bwd, z_upd
        args = [t.to(sd).contiguous() for t in v2_base]
        z_upd = fused_edge.fused_edge_step_reference(*args, batch.receivers, batch.edge_gid,
                                                     batch.n_graphs)[0]
        v2f = lambda: fused_edge.fused_edge_step(  # noqa: E731
            *args, batch.receivers, aux, batch.n_graphs, batch.tile)
        for name, t in zip(("z_upd", "R", "M"), v2f()):
            put(f"v2fwd {sd_name} {name}", t)
            fwd_out[f"v2fwd {sd_name} {name}"] = t.float().cpu()
        timed(f"v2fwd {sd_name}", v2f)
        cots = (z_upd, v2_cots[0].to(sd), *v2_cots[1:])
        v2 = lambda: fused_edge.fused_edge_step_backward(  # noqa: E731
            *args, batch.receivers, aux, batch.n_graphs, batch.tile, *cots)
        for name, t in zip(("da_u", "da_v", "dg_v", "dg_u", "de", "dWe", "db0", "dW2", "db2"),
                           v2()):
            put(f"v2bwd {sd_name} {name}", t)
        timed(f"v2bwd {sd_name}", v2)
        args = [t.to(sd).contiguous() for t in pair_base]
        z_upd = fused_edge.fused_edge_step2_reference(*args, pair.receivers, pair.senders,
                                                      pair_aux, pair.n_graphs, pair.tile)[0]
        p2f = lambda: fused_edge.fused_edge_step2(  # noqa: E731
            *args, pair.receivers, pair.senders, pair_aux, pair.n_graphs, pair.tile)
        for name, t in zip(("z_upd", "R", "M"), p2f()):
            put(f"pairfwd {sd_name} {name}", t)
            fwd_out[f"pairfwd {sd_name} {name}"] = t.float().cpu()
        timed(f"pairfwd {sd_name}", p2f)
        cots = (z_upd, pair_cots[0].to(sd), *pair_cots[1:])
        p2 = lambda: fused_edge.fused_edge2_bwd(  # noqa: E731
            *args, pair.receivers, pair.senders, pair_aux, pair.n_graphs, pair.tile, *cots)
        for name, t in zip(("de", "dpre1", "dpre2", "du_r", "dv_r", "dWe", "db0", "dW2", "db2"),
                           p2()):
            put(f"pairbwd {sd_name} {name}", t)
        timed(f"pairbwd {sd_name}", p2)
        del args, z_upd, cots
        rows = base[2].to(sd)
        csr = lambda: scatter_csr.csr_segment_sum(  # noqa: E731
            rows, batch.snd_run_sorted, batch.snd_block_tile, Np, batch.tile,
            perm=batch.snd_run_perm)
        put(f"csr {sd_name}", csr())
        timed(f"csr {sd_name}", csr, 50)
        device_timed(f"csr {sd_name}", csr)
        for view, b in (("fused", batch), ("fused2", pair)):
            streams = [randn(b.num_edges_padded, L).to(sd) for _ in range(2)]
            ps = lambda b=b, streams=streams: scatter_csr.csr_segment_sum_pair(  # noqa: E731
                *streams, b.snd_run_sorted, b.snd_block_tile, b.num_nodes_padded, b.tile,
                perm=b.snd_run_perm)
            try:
                got = ps()
            except ValueError:  # a tree whose pair sum takes fp32 streams only
                continue
            put(f"pair {view} {sd_name}", torch.stack(got))
            timed(f"pair {view} {sd_name}", ps, 50)
            device_timed(f"pair {view} {sd_name}", ps)
        torch.cuda.empty_cache()
    diffs = {}
    if save is not None:
        torch.save(fwd_out, save)
    if ref is not None:
        other = torch.load(ref)
        diffs = {k: float((v - other[k]).abs().max()) for k, v in fwd_out.items()}
    out.write_text(json.dumps({"hashes": hashes, "times": times, "diffs": diffs}, indent=1))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, help="root of the other checkout")
    ap.add_argument("--require", nargs="*",
                    default=["fwd ", "bwd ", "v2fwd ", "v2bwd ", "pairfwd ", "pairbwd ",
                             "csr "],
                    help="output name prefixes that must be bit-equal")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--save", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--ref", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker, args.save, args.ref)
        return 0
    OUT.mkdir(parents=True, exist_ok=True)
    runs: dict[str, list] = {"this": [], "other": []}
    trees = {"this": ROOT, "other": args.other.resolve()}
    saved = OUT / "other_forwards.pt"
    for i, label in enumerate(("other", "this", "this", "other")):
        out = OUT / f"{label}{i}.json"
        extra = (["--save", str(saved)] if i == 0 else
                 ["--ref", str(saved)] if label == "this" else [])
        subprocess.run([sys.executable, str(Path(__file__).resolve()), "--worker", str(out),
                        *extra], cwd=trees[label], check=True)
        runs[label].append(json.loads(out.read_text()))
    bad = []
    for name, h in runs["this"][0]["hashes"].items():
        same = runs["other"][0]["hashes"].get(name) == h
        diff = runs["this"][0]["diffs"].get(name)
        print(f"{name}: {'bit-equal' if same else 'differs'}"
              + ("" if diff is None else f", largest difference {diff:.3e}"), flush=True)
        if not same and any(name.startswith(p) for p in args.require):
            bad.append(name)
    for name in runs["this"][0]["times"]:
        t = {k: [r["times"].get(name) for r in v] for k, v in runs.items()}
        other = ("-" if t["other"][0] is None else
                 f"{t['other'][0]:.4f} / {t['other'][1]:.4f} ms")
        print(f"time {name}: other {other}, this {t['this'][0]:.4f} / {t['this'][1]:.4f} ms",
              flush=True)
    if bad:
        print(f"port_tree_compare: required outputs differ: {bad}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
