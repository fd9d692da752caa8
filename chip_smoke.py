#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (``p_div_gnn_tpu_torch``) serves
P-DivGNN on an NVIDIA GPU. Run from the root of a checkout:

    python3 chip_smoke.py

It needs one CUDA card and nvcc; it imports nothing of JAX or of the JAX
package. Phases, in order (any failure exits nonzero and prints no result):

1. the card's name and power limit (nvidia-smi), then the kernel build: nvcc
   compiles ``p_div_gnn_tpu_torch/csrc/fused_edge3_fwd.cu`` into
   ``build/p_div_gnn_tpu_torch/`` and ctypes loads it;
2. kernel: at the flagship serving shapes (16 RCM-ordered plate-with-hole
   meshes of the benchmark generator, latent 128) the fused edge-step kernel
   is held against its plain PyTorch version on the card, in fp32 and bf16
   streams, and both are timed with CUDA events;
3. serve: the committed checkpoint answers 3 requests of 16 meshes each
   through ``Predictor`` (fused3, fp32 streams); the kernel's launch count
   over those requests must be exactly 10 per request, every field finite,
   and each request must match the plain ``xla`` path on the card;
4. a ``{"kernels": [...]}`` line with each ported kernel's numbers, then the
   last line ``{"ok": true, "device": {...}}``.

Everything it builds goes to ``build/``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CHECKPOINT = ROOT / "checkpoints" / "elast_200e_div" / "model_weights.ckpt"
LATENT = 128
STEPS = 10
N_MESHES = 16
REQUEST_SEEDS = (0, 1, 2)
# published dense peaks of one H100 SXM (NVIDIA data sheet) at 700 W
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # fp32 FMA, bf16 tensor
# kernel vs plain version: the JAX package's own fused3 op tolerances
# (tests/test_fused3_op.py:65-70 fp32, :128 bf16), as rtol = atol
KERNEL_TOL = {
    "float32": {"z_upd": 1e-5, "R": 1e-4, "M": 1e-3},
    "bfloat16": {"z_upd": 3e-2, "R": 3e-2, "M": 3e-2},
}
# fused3 vs xla model outputs in standardized units (tests/test_fused.py:34)
SERVE_RTOL, SERVE_ATOL = 2e-4, 2e-5


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(*parts: object) -> None:
    print(*parts, flush=True)


def build_request(seed: int) -> list:
    """16 periodic plate-with-hole meshes as the benchmark generates them
    (bench.py:95-138); the divergence operator is left out, serving does
    not read it."""
    import numpy as np

    from p_div_gnn_tpu_torch.datagen.mesher import hole_plate_mesh
    from p_div_gnn_tpu_torch.graphs.batching import GraphSample
    from p_div_gnn_tpu_torch.graphs.build import mesh_to_graph
    from p_div_gnn_tpu_torch.graphs.labels import compute_node_labels
    from p_div_gnn_tpu_torch.graphs.periodic import compute_periodic_graph

    rng = np.random.default_rng(seed)
    samples = []
    for i in range(N_MESHES):
        mesh = hole_plate_mesh(
            100.0, 100.0,
            radius=float(rng.uniform(15, 30)),
            hole_center=(50.0, 50.0),
            hole_refinement_factor=8.0,
            global_mesh_refinement_size=2.5,
            seed=seed + i,
        )
        g = compute_periodic_graph(mesh_to_graph(mesh))
        n = g.num_nodes
        samples.append(
            GraphSample(
                graph=g,
                mean_stress=rng.normal(size=3).astype(np.float32),
                local_stress=rng.normal(size=(n, 3)).astype(np.float32),
                node_labels=compute_node_labels(mesh),
                div_data=np.zeros(0, np.float32),
                div_row=np.zeros(0, np.int64),
                div_col=np.zeros(0, np.int64),
            )
        )
    return samples


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of one call, by CUDA events over ``iters`` calls
    after two warm-up calls."""
    import torch

    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def kernel_phase(batch) -> dict:
    """Hold fused_edge_step3's kernel against its plain version on the card
    at the batch's shapes, in both stream dtypes; time both."""
    import torch

    from p_div_gnn_tpu_torch.ops.fused_edge3 import (
        fused_edge_step3,
        fused_edge_step3_reference,
    )

    dev = batch.receivers.device
    Np, Ep, L = batch.num_nodes_padded, batch.num_edges_padded, LATENT
    NB = int(batch.edge_block_tile.shape[0])
    e_real = int(batch.edge_mask.sum())
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape: int, scale: float = 1.0) -> torch.Tensor:
        return torch.randn(shape, generator=gen, device=dev) * scale

    x = randn(Np, L)
    base = {
        "x": x,
        "g_x": x.index_select(0, batch.senders),
        "e": randn(Ep, L),
        "w_u": randn(L, L, scale=L**-0.5), "w_v": randn(L, L, scale=L**-0.5),
        "w_e": randn(L, L, scale=L**-0.5), "b0": randn(L),
        "w2": randn(L, L, scale=L**-0.5), "b2": randn(L),
    }
    aux = (batch.edge_gid, batch.edge_block_tile)
    results = {}
    for sd_name, sd in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        args = [base[k].to(sd).contiguous() for k in base]
        kern = lambda: fused_edge_step3(  # noqa: E731
            *args, batch.receivers, aux, batch.n_graphs, batch.tile
        )
        plain = lambda: fused_edge_step3_reference(  # noqa: E731
            *args, batch.receivers, batch.edge_gid, batch.n_graphs
        )
        got, want = kern(), plain()
        torch.cuda.synchronize()
        errs = {}
        for name, a, b in zip(("z_upd", "R", "M"), got, want):
            check(a.shape == b.shape and a.dtype == b.dtype,
                  f"{sd_name} {name}: {a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
            a, b = a.float(), b.float()
            check(bool(torch.isfinite(a).all()), f"{sd_name} {name}: non-finite kernel output")
            tol = KERNEL_TOL[sd_name][name]
            err = (a - b).abs()
            excess = float((err - tol * (1.0 + b.abs())).max())
            errs[name] = float(err.max())
            check(excess <= 0.0,
                  f"{sd_name} {name}: kernel vs plain max abs err {errs[name]:.3e} "
                  f"outside rtol=atol={tol:g}")
        s = torch.finfo(sd).bits // 8
        n_bytes = (s * (Np * L + 3 * Ep * L + 4 * L * L + 2 * L)
                   + 4 * (2 * Ep + NB) + 4 * (Np * L + 8 * L))
        flops = 2 * 7 * L * L * e_real
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[sd_name] * 1e3
        res = {
            "max_abs_err": max(errs.values()), "errs": errs,
            "ms": cuda_ms(kern, 20), "plain_ms": cuda_ms(plain, 10),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "flops": flops, "bytes": n_bytes,
        }
        results[sd_name] = res
        say(f"kernel fused_edge3_fwd {sd_name}: Np={Np} Ep={Ep} L={L} blocks={NB} "
            f"real_edges={e_real} max_abs_err "
            + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
            + f" kernel_ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f} "
            f"bound_ms={res['bound_ms']:.4f} ({res['bound_by']}: "
            f"{flops / 1e9:.2f} GFLOP, {n_bytes / 1e9:.3f} GB)")
    return results


def serve_phase(requests: list) -> dict:
    """Answer the requests with the fused3 Predictor, count the kernel's
    launches over exactly those requests, then hold every answer against
    the plain xla path."""
    import numpy as np
    import torch

    from p_div_gnn_tpu_torch.graphs.batching import pack_batch
    from p_div_gnn_tpu_torch.inference import Predictor
    from p_div_gnn_tpu_torch.ops.fused_edge3 import fused_edge_step3

    fused = Predictor(CHECKPOINT, LATENT, STEPS, scatter_impl="fused3", device="cuda")
    plain = Predictor(CHECKPOINT, LATENT, STEPS, scatter_impl="xla", device="cuda")
    stats = fused.stats
    say(f"serve: checkpoint {CHECKPOINT.relative_to(ROOT)} (epoch {fused.epoch})")

    fused_edge_step3.launches = 0
    answers, latencies = [], []
    for samples in requests:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        answers.append(fused.predict(samples))  # ends in a device→host copy
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
    launches = fused_edge_step3.launches
    check(launches == STEPS * len(requests),
          f"fused_edge3_fwd launched {launches} times over {len(requests)} requests, "
          f"expected {STEPS * len(requests)}")
    say(f"serve: fused_edge3_fwd launched {launches} times over {len(requests)} requests")

    for r, (samples, answer) in enumerate(zip(requests, answers)):
        worst = ratio = 0.0
        check(len(answer) == len(samples), f"request {r}: {len(answer)} fields")
        want = plain.predict(samples)
        for s, got, ref in zip(samples, answer, want):
            check(got.shape == (s.num_nodes, 3), f"request {r}: field shape {got.shape}")
            check(bool(np.isfinite(got).all()), f"request {r}: non-finite field")
            z_got = (got - stats.mean_local_stress) / stats.std_local_stress
            z_ref = (ref - stats.mean_local_stress) / stats.std_local_stress
            err = np.abs(z_got - z_ref)
            share = float((err / (SERVE_ATOL + SERVE_RTOL * np.abs(z_ref))).max())
            worst, ratio = max(worst, float(err.max())), max(ratio, share)
            check(share <= 1.0, f"request {r}: fused3 vs xla max abs err "
                  f"{float(err.max()):.3e} (standardized) outside rtol={SERVE_RTOL} "
                  f"atol={SERVE_ATOL} ({share:.2f} of the allowance)")
        n_nodes = sum(s.num_nodes for s in samples)
        say(f"serve request {r}: {len(samples)} meshes, {n_nodes} nodes, latency "
            f"{latencies[r] * 1e3:.1f} ms (pack + forward + copy back), "
            f"{n_nodes / latencies[r]:.0f} nodes/s, fused3 vs xla max abs err "
            f"(standardized) {worst:.3e}, {ratio:.2f} of the allowance")

    # device time of the model forward alone on request 0's batch
    batch = pack_batch(requests[0], reorder="rcm", sender_view=False,
                       div_ell=False).to("cuda")
    with torch.no_grad():
        fwd = {name: cuda_ms(lambda m=p.model: m(batch, stats), 5)
               for name, p in (("fused3", fused), ("xla", plain))}
    say(f"serve forward device time (request 0 batch): fused3 {fwd['fused3']:.3f} ms, "
        f"xla {fwd['xla']:.3f} ms")
    return {"launches": launches, "latencies": latencies, "forward_ms": fwd}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: this check needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    try:
        import p_div_gnn_tpu_torch
    except ImportError as exc:
        raise SmokeFailure(f"the port is not in this checkout: {exc}") from exc
    check(Path(p_div_gnn_tpu_torch.__file__).resolve().parents[1] == ROOT,
          f"p_div_gnn_tpu_torch imported from outside {ROOT}")
    check(CHECKPOINT.is_file(), f"missing checkpoint {CHECKPOINT}")
    t_start = time.perf_counter()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    say(smi)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    from p_div_gnn_tpu_torch.graphs.batching import pack_batch
    from p_div_gnn_tpu_torch.ops.fused_edge3 import _library

    built = _library()
    say(f"build: {built.path.relative_to(ROOT)} in {built.build_seconds:.1f} s")
    for line in built.build_log.splitlines():
        if "registers" in line or "spill" in line:
            say(f"build: {line.strip()}")

    t0 = time.perf_counter()
    requests = [build_request(seed) for seed in REQUEST_SEEDS]
    say(f"requests: {len(requests)} x {N_MESHES} meshes built in "
        f"{time.perf_counter() - t0:.1f} s")
    batch = pack_batch(requests[0], reorder="rcm", sender_view=False,
                       div_ell=False).to("cuda")
    kern = kernel_phase(batch)
    serve = serve_phase(requests)

    k32 = kern["float32"]
    say(json.dumps({"kernels": [{
        "name": "fused_edge3_fwd",
        "route": "cuda",
        "source": "p_div_gnn_tpu_torch/csrc/fused_edge3_fwd.cu",
        "replaces": "p_div_gnn_tpu/ops/fused_edge3.py:94",
        "launches": serve["launches"],
        "max_abs_err": k32["max_abs_err"],
        "ms": k32["ms"],
        "plain_ms": k32["plain_ms"],
        "bound_ms": k32["bound_ms"],
        "bound_by": k32["bound_by"],
        "library_ms": None,
    }]}))
    say(f"total {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr, flush=True)
        sys.exit(1)
