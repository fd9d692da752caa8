#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (``p_div_gnn_tpu_torch``) serves
and trains P-DivGNN on an NVIDIA GPU. Run from the root of a checkout:

    python3 chip_smoke.py

It needs one CUDA card and nvcc; it imports nothing of JAX or of the JAX
package. Phases, in order (any failure exits nonzero and prints no result):

1. the card's name and power limit (nvidia-smi), then the kernel builds:
   nvcc compiles ``p_div_gnn_tpu_torch/csrc/{fused_edge3_fwd,fused_edge3_bwd,
   segment_sum_csr,fused_edge_fwd,fused_edge_bwd,fused_edge2_fwd,
   fused_edge2_bwd,mgn_edge_fwd}.cu`` in parallel into ``build/p_div_gnn_tpu_torch/`` and
   ctypes loads them; ptxas' registers and spills are printed;
2. kernels: at the flagship shapes (16 RCM-ordered plate-with-hole meshes of
   the benchmark generator, drawn once and packed twice: receiver-major and
   pair-blocked; latent 128) each kernel is held against its plain PyTorch
   version on the card and both are timed with CUDA events (the segment
   sums also beside ``index_add_``): the fused3 and the v2 ("fused") edge
   steps' forwards on a serving request's batch, in fp32 and bf16 streams;
   their backwards and the block-CSR segment sum (fp32, bf16) on the
   training batch's sender view in run order; the pair segment sum (fp32,
   bf16) on both training batches' sender views in run order, as fused and
   fused2 call it; the pair-blocked ("fused2")
   edge step's forward and backward on the pair-blocked training batch, in
   fp32 and bf16 streams; MeshGraphNets' edge update forward
   (``mgn_edge_fwd``, fp32) on the training batch's live slots (the v2 and
   pair-blocked forwards and backwards
   also print their ptxas figures at each width and dtype and the device
   time of each sub-kernel; the forwards must give two bit-equal calls
   and, in fp32, z_upd bit-equal to the plain version); the two segment
   sums also once at L = 18 and the pair sum with bf16 rows and both ways
   of laying its streams on the warps; then every fused kernel once at L =
   16 (zero-padded to a width it is built for), 256, 320 and 512 (the wide
   variant), both dtypes, against its plain version on a batch of 2
   meshes, and one fp32 fused3 train step at latent 384 on that batch
   against xla;
3. serve: the committed checkpoint answers 3 requests of 16 meshes each
   through ``Predictor`` with fused3, fused and fused2 (fp32 streams); each
   path's forward kernel must launch exactly 10 times per request and no
   other kernel at all, every field must be finite, and each request must
   match the plain ``xla`` path;
4. train: ``Trainer.train_step`` takes 5 Adam steps of the benchmark's
   training step (``bench.py``: latent 128, 10 message-passing steps, no
   remat, NMSE + 10 x divergence, lr 1e-3) from one seeded random init,
   with fused3 fp32, xla fp32, fused3 bf16, fused fp32, fused bf16, fused2
   fp32 and fused2 bf16 streams (fused2 on the pair-blocked batch), and 3
   steps each of pallas and hybrid (fp32); losses and gradients must be
   finite, each fp32 impl must match xla on the step-1 loss and gradients,
   the loss must fall, bf16's step-1 loss must be near fp32's, and each
   step must launch exactly the kernels of its path: 10 of each of its
   three kernels per fused3, fused or fused2 step, 10 block-CSR segment
   sums per pallas step and 19 per hybrid step (the last step's edge
   update gets no gradient), none per xla step; then MeshGraphNets
   (``models/meshgraphnets.py``: latent 128, 15 blocks, lr 1e-4) takes 3
   steps on the same meshes with node fields drawn from a seed: finite
   losses, one ``mgn_edge_fwd`` launch a block and step and no port kernel
   but it and #3; then GraphCast_small (``models/graphcast.py`` at the
   benchmark cell's size: the 1° grid and the level 2-5 multimesh, latent
   512, 16 steps, AdamW with clipping) takes 3 steps: the graph's counts as
   configured, finite losses, the first within the cell's limit of the
   reference's, 54 launches of #3 a step and no other port kernel (none of
   ``mgn_edge_fwd``: the L = 512 SiLU edge updates take the plain route);
5. cli: the user's path at the flagship width. An on-disk dataset of 32
   train and 16 test meshes (the benchmark's mesher parameters, a
   learnable target) is written with the port (``write_vtk``,
   ``save_sample_npz``, ``configio.write_csv``); ``cli.train_main`` trains
   fused3 fp32 and bf16 for 3 epochs on configs derived from the committed
   ``config_train_div_flagship{,_bf16}.yml`` (config → dataset →
   bucketed ``GraphLoader`` → ``Trainer.fit`` with checkpoints), and
   ``cli.infer_main`` runs the committed ``config_inference_div.yml`` with
   fused3 on the fp32 run's last checkpoint. The train loss must fall, the
   logged tags be there, the checkpoints read back (the last one's params
   bit-equal to the trained model's), #2 and #3 launch 10 times per train
   step and #1 20 (the runner keeps the JAX default ``remat_steps=True``,
   which runs each step's forward again in the backward) and 10 per eval
   or inference batch, and the inferred fields
   match ``Predictor`` on the plain xla path at the serve tolerance; #1, #2
   and #3 must match their plain versions on the first loader batch (whose
   trailing padding the fused3 wrappers trim) at the kernel phases'
   tolerances; it prints the dataset's write and load seconds, seconds per
   epoch, the median step of the CLI run's trainer (remat on) on the
   loader's bucketed batches, edges/s, peak memory and the batches'
   padding;
6. parallel: the parallel tier at full width over 2 spawned ranks (NCCL
   with a card per rank, else gloo with both ranks on card 0 and their
   collectives staged through host memory; the phase prints which, and its
   gloo times are no scaling or collective times). #1-#3 are held against
   their plain versions on a partitioned shard's extended ``[local ++
   ghost]`` layout; then (a) data-parallel fused3 (``Trainer(group=)``, 8
   meshes a rank, 5 fp32 steps and 2 bf16 ones): the step-1 loss, the
   gradients averaged over the ranks and the parameters after Adam must
   match the single-process step on the 16 meshes, the loss must fall and
   bf16 stay near fp32; (b) the 16 meshes edge-partitioned over the ranks
   (``partition_batch``) in both halo modes: the committed checkpoint's
   forward against its single-process forward at the serve tolerance, one
   fused3 fp32 and one bf16 train step, and (c) one fused fp32 step (a2a),
   each held the same way; every counted run must launch exactly its
   path's kernels on each rank (10 of #1, #2 and #3 a fused3 step, 10 of
   #1 a forward). With four cards the checkpoint's partitioned forward
   also runs at D = 4 (both halo modes, NCCL) and prints its share of the
   serve allowance. Freed Adam entries (gradient inside fp32 noise) that
   moved the other way may number at most 2 a step. It prints the plans
   (Nl, El, Ep2, D·Hp per rank, halo bytes per step), per-rank step ms, peak
   memory, and the rows of ``measure_dp_scaling`` at the rank counts the
   cards allow;
7. tools: the user's tools through the port's CLI functions, in a
   temporary directory under ``build/``: ``cli.generate_main`` writes a
   linear set (40 samples, 32 test), a Neo-Hookean set (10, 8 test), and 4
   samples each with ``--bc neumann`` and ``--element quad`` (8 worker
   processes); the native graph library (``graphs/native.py``, g++) must be
   built and array-equal to the numpy paths on the generated meshes;
   ``cli.infer_main`` serves the six committed checkpoints with their
   committed inference configs on fused3 (fp32): #1 launches 10 times a
   batch and nothing else does, every field within the serve allowance of
   ``Predictor`` on xla, and ``elast_200e_div_bf16`` also through bf16
   streams within 3e-2 of xla fp32; ``cli.compare_main`` over the elastic
   and the hyperelastic folders gives the headline table, held against the
   JAX package's figures on the same sets (``COMPARE_REFERENCE``, from
   ``scripts/port_compare_reference.py``); the GNN-vs-FEM sweep (5 factors,
   means of 5; the plain xla forward, as the JAX package's benchmark runs)
   gives 303 and 11,436 nodes at factors 1 and 100 and positive times; the
   committed checkpoint exported to ``.pth`` and read back serves a request
   bit-equal to the msgpack-loaded model;
8. a ``{"kernels": [...]}`` line with each ported kernel's numbers (the
   pair segment sum's row also has its bf16 numbers under ``bfloat16`` and
   each sender view's numbers and launches under ``views``; the launches
   count every phase's runs, the parallel ranks' and the tools phase's
   too; ``mgn_edge_fwd`` replaces no TPU kernel, and its launches are the
   MeshGraphNets steps'), then the last line ``{"ok": true, "device": {...}}``.

Everything it builds goes to ``build/``.
"""

from __future__ import annotations

import json
import math
import statistics
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
# (tests/test_fused3_op.py:65-70 fp32, :128 bf16), as rtol = atol; the v2
# op's are the same numbers (tests/test_fused_op.py:86-91)
KERNEL_TOL = {
    "float32": {"z_upd": 1e-5, "R": 1e-4, "M": 1e-3},
    "bfloat16": {"z_upd": 3e-2, "R": 3e-2, "M": 3e-2},
}
# fused3 vs xla model outputs in standardized units (tests/test_fused.py:34)
SERVE_RTOL, SERVE_ATOL = 2e-4, 2e-5
# backward kernel vs plain: the JAX package's fused3 gradient tolerance
# (tests/test_fused3_op.py:87-95) in fp32, its bf16 tolerance (:128); the v2
# gradient tolerance is the same (tests/test_fused_op.py:116-120)
BWD_TOL = {"float32": 2e-4, "bfloat16": 3e-2}
# segment sum vs plain (tests/test_fused3_op.py:128-131)
CSR_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# MeshGraphNets' edge update kernel vs plain, fp32, as rtol = atol: the
# kernel's bf16x6 split products on the tensor cores and cuBLAS's fp32 FMA
# chains each round a 128-term sum at fp32's ~6e-8, in their own ways,
# through three layers and the LayerNorm's scaling by rstd: ~2e-6 apart,
# so 1e-5 is ~5x room; a TF32 product (10 mantissa bits) would be ~1e-3
# apart
MGN_EDGE_TOL = 1e-5
# the training step of bench.py:166-178
TRAIN_STEPS, LEARNING_RATE, DIV_PENALTY = 5, 1e-3, 10.0
LOSS_RTOL = 1e-5  # each impl vs xla step-1 loss, fp32
BF16_LOSS_RTOL = 3e-2  # fused3 bf16 vs fp32 step-1 loss
# each impl vs xla step-1 gradients, fp32: for each parameter tensor
# ||g_impl - g_xla|| / ||g_xla|| must stay below GRAD_RTOL. Derived from
# scripts/port_fp32_noise.py --grad on the card at this size (PERF.md): the
# fp32 xla and fused3 gradients are at most 2.3e-5 and 2.8e-5 from the fp64
# one over all parameters, so they can be at most 5.1e-5 apart; 2e-4 leaves
# a margin of ~4x over that bound for other seeds and cards.
GRAD_RTOL = 2e-4
# kernel launches per training step of each path (counters of
# launch_counts(); every other counter must stay put)
def step_launches(impl: str) -> dict:
    return {
        "fused3": {"fused_edge3_fwd": STEPS, "fused_edge3_bwd": STEPS, "segment_sum_csr": STEPS},
        "fused": {"fused_edge_fwd": STEPS, "fused_edge_bwd": STEPS,
                  "segment_sum_csr_pair": STEPS},
        # the last step's z_upd gets zero cotangents, and its backward still
        # runs the kernel and the sender-side pair sum
        "fused2": {"fused_edge2_fwd": STEPS, "fused_edge2_bwd": STEPS,
                   "segment_sum_csr_pair": STEPS},
        "pallas": {"segment_sum_csr": STEPS},  # the receiver scatter's forward
        # the two sender gathers' backwards of every step but the last
        # step's edge update: the decoder reads only x, so no gradient
        # reaches that gather and autograd never runs its backward
        "hybrid": {"segment_sum_csr": 2 * STEPS - 1},
        "xla": {},
    }[impl]


# the serving forward launches only the edge step's forward kernel
SERVE_LAUNCHES = {"fused3": {"fused_edge3_fwd": 1}, "fused": {"fused_edge_fwd": 1},
                  "fused2": {"fused_edge2_fwd": 1}}


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
    from p_div_gnn_tpu_torch.datagen.workload import build_samples

    return build_samples(N_MESHES, seed, div_operator=False)


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


def bound(flops: float, n_bytes: float, sd_name: str) -> tuple[float, str]:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the peak rate of their type, in ms (an
    fp32 product run as six bf16 products on the tensor cores counts as
    those six, at the bf16 rate)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[sd_name] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def held(name: str, got, want, tol: float) -> tuple[float, float]:
    """Max abs error of ``got`` against ``want`` and the largest share of
    the allowance it uses; fails outside rtol = atol = tol (elementwise,
    |got - want| <= tol·(1 + |want|))."""
    import torch

    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name}: {tuple(got.shape)}/{got.dtype} vs {tuple(want.shape)}/{want.dtype}")
    a, b = got.float(), want.float()
    check(bool(torch.isfinite(a).all()), f"{name}: non-finite kernel output")
    err = (a - b).abs()
    worst = float(err.max())
    share = float((err / (tol * (1.0 + b.abs()))).max())
    check(share <= 1.0,
          f"{name}: kernel vs plain max abs err {worst:.3e} outside rtol=atol={tol:g} "
          f"({share:.2f} of the allowance)")
    return worst, share


def sub_kernel_ms(fn, subs: tuple[str, ...]) -> dict:
    """Mean device time (ms) of each named sub-kernel over three calls of
    ``fn`` under torch.profiler, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    times = {sub: 0.0 for sub in subs}
    for e in prof.key_averages():
        for sub in subs:
            if sub in e.key:
                times[sub] += e.device_time_total / 3e3
    check(sum(times.values()) > 0, f"the profiler saw none of {subs} on the device")
    return times


def ptxas_figures(built, smem=None) -> list[str]:
    """Each entry function's ptxas figures from a build's log (``-Xptxas
    -v``): its name with stream dtype and width, registers, stack frame and
    spill bytes, and, where ``smem(bf16, L, which)`` gives them, the tile
    (which 0) or weight-grad (which 1) kernel's dynamic shared memory."""
    import re

    out, name, frame = [], None, ""
    for line in built.build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        if name is None:
            continue
        if "stack frame" in line:
            frame = line.strip()
        m = re.search(r"Used (\d+) registers", line)
        if m:
            # the kernel's name: the <length><name> of the mangled name that
            # ends in _kernel (or _kernel_ws)
            label = next((name[m.end(1):m.end(1) + int(m.group(1))]
                          for m in re.finditer(r"(?=(\d+))", name)
                          if name[m.end(1):m.end(1) + int(m.group(1))].endswith(
                              ("_kernel", "_kernel_ws"))),
                         name[:60])
            width = re.search(r"Li(64|128|256)E", name)
            bf16 = "bfloat16" in name
            if width:
                label += f"<{'bf16' if bf16 else 'fp32'}, L={width.group(1)}>"
            fig = f"{label}: {m.group(1)} registers, {frame}"
            if smem is not None and width and ("tile" in label or "wgrad" in label):
                fig += f", {smem(int(bf16), int(width.group(1)), 0 if 'tile' in label else 1)} " \
                       "bytes of dynamic shared memory"
            out.append(fig)
            name, frame = None, ""
    return out


def edge_step_inputs(batch, gen, L: int = LATENT, n_ext: int | None = None):
    """Random inputs of the fused edge step at the batch's shapes: x and e
    ~ N(0, 1), g_x = x[senders], weights ~ N(0, 1/L), biases ~ N(0, 1).
    ``n_ext``: the senders address that many rows, x being the first Np
    (an edge-partitioned shard's ``[local ++ ghost]`` rows)."""
    import torch

    dev = batch.receivers.device
    Np, Ep = batch.num_nodes_padded, batch.num_edges_padded

    def randn(*shape: int, scale: float = 1.0) -> torch.Tensor:
        return torch.randn(shape, generator=gen, device=dev) * scale

    x_ext = randn(n_ext or Np, L)
    x = x_ext[:Np]
    return {
        "x": x,
        "g_x": x_ext.index_select(0, batch.senders),
        "e": randn(Ep, L),
        "w_u": randn(L, L, scale=L**-0.5), "w_v": randn(L, L, scale=L**-0.5),
        "w_e": randn(L, L, scale=L**-0.5), "b0": randn(L),
        "w2": randn(L, L, scale=L**-0.5), "b2": randn(L),
    }


def kernel_phase(batch) -> dict:
    """Hold fused_edge_step3's kernel against its plain version on the card
    at the batch's shapes, in both stream dtypes (two calls must be
    bit-equal); time both."""
    import torch

    from p_div_gnn_tpu_torch.ops import cuda_build
    from p_div_gnn_tpu_torch.ops.fused_edge3 import fused_edge_step3, fused_edge_step3_reference

    dev = batch.receivers.device
    Np, Ep, L = batch.num_nodes_padded, batch.num_edges_padded, LATENT
    NB = int(batch.edge_block_tile.shape[0])
    real = batch.edge_mask.bool()
    e_real = int(real.sum())
    # x[r]·Wu and x[r]·Wv are the same for every slot of a receiver: the
    # function needs them once per receiver of a real slot
    n_rcv = int(torch.unique(batch.receivers[real]).numel())
    base = edge_step_inputs(batch, torch.Generator(device=dev).manual_seed(0))
    aux = (batch.edge_gid, batch.edge_block_tile)
    n_parts = int(cuda_build.library("fused_edge3_fwd").lib.pdg_fused_edge3_fwd_parts())
    say(f"kernel fused_edge3_fwd: {n_parts} parts (one CTA per SM)")
    results = {}
    for sd_name, sd in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        args = [base[k].to(sd).contiguous() for k in base]
        kern = lambda: fused_edge_step3(  # noqa: E731
            *args, batch.receivers, aux, batch.n_graphs, batch.tile
        )
        plain = lambda: fused_edge_step3_reference(  # noqa: E731
            *args, batch.receivers, batch.edge_gid, batch.n_graphs
        )
        got, again, want = kern(), kern(), plain()
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"fused_edge3_fwd {sd_name}: two calls differ")
        checked = {name: held(f"fused_edge3_fwd {sd_name} {name}", a, b,
                              KERNEL_TOL[sd_name][name])
                   for name, a, b in zip(("z_upd", "R", "M"), got, want)}
        errs = {name: v[0] for name, v in checked.items()}
        del got, again, want
        s = torch.finfo(sd).bits // 8
        # read: x, the real slots' g and e, the weights, biases, rcv and gid;
        # written: z_upd (every slot), R and M
        n_bytes = (s * (Np * L + 2 * e_real * L + Ep * L + 4 * L * L + 2 * L)
                   + 4 * 2 * Ep + 4 * (Np * L + 8 * L))
        # per real slot g·Wu, g·Wv, e·We and h·W2 twice; per receiver x·Wu, x·Wv
        flops = 2 * L * L * (5 * e_real + 2 * n_rcv)
        b_ms, b_by = bound(flops, n_bytes, sd_name)
        res = {
            "max_abs_err": max(errs.values()), "errs": errs,
            "ms": cuda_ms(kern, 20), "plain_ms": cuda_ms(plain, 10),
            "bound_ms": b_ms, "bound_by": b_by,
        }
        results[sd_name] = res
        say(f"kernel fused_edge3_fwd {sd_name}: Np={Np} Ep={Ep} L={L} blocks={NB} "
            f"real_edges={e_real} receivers={n_rcv} max_abs_err "
            + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
            + " share of the allowance "
            + " ".join(f"{k}={v[1]:.3f}" for k, v in checked.items())
            + f" kernel_ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f} "
            f"bound_ms={res['bound_ms']:.4f} ({res['bound_by']}: "
            f"{flops / 1e9:.2f} GFLOP, {n_bytes / 1e9:.3f} GB), "
            f"share of the bound {b_ms / res['ms']:.3f}; two calls bit-equal")
        torch.cuda.empty_cache()
    return results


def serve_phase(requests: list) -> dict:
    """Answer the requests with the fused3 and the fused Predictors, count
    each path's kernel launches over exactly those requests (from 0), then
    hold every answer against the plain xla path."""
    import numpy as np
    import torch

    from p_div_gnn_tpu_torch.graphs.batching import pack_batch
    from p_div_gnn_tpu_torch.inference import Predictor

    plain = Predictor(CHECKPOINT, LATENT, STEPS, scatter_impl="xla", device="cuda")
    stats = plain.stats
    say(f"serve: checkpoint {CHECKPOINT.relative_to(ROOT)} (epoch {plain.epoch})")
    want = [plain.predict(samples) for samples in requests]
    models = {"xla": plain.model}
    results = {}
    for impl, per_step in SERVE_LAUNCHES.items():
        fused = Predictor(CHECKPOINT, LATENT, STEPS, scatter_impl=impl, device="cuda")
        models[impl] = fused.model
        reset_launch_counts()
        answers, latencies = [], []
        for samples in requests:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            answers.append(fused.predict(samples))  # ends in a device→host copy
            torch.cuda.synchronize()
            latencies.append(time.perf_counter() - t0)
        launches = launch_counts()
        expect = {k: STEPS * len(requests) * per_step.get(k, 0) for k in launches}
        check(launches == expect, f"serve {impl}: kernel launches {launches} over "
              f"{len(requests)} requests, expected {expect}")
        say(f"serve {impl}: kernel launches over {len(requests)} requests {launches}")

        for r, (samples, answer) in enumerate(zip(requests, answers)):
            worst = ratio = 0.0
            check(len(answer) == len(samples), f"{impl} request {r}: {len(answer)} fields")
            for s, got, ref in zip(samples, answer, want[r]):
                check(got.shape == (s.num_nodes, 3), f"{impl} request {r}: shape {got.shape}")
                check(bool(np.isfinite(got).all()), f"{impl} request {r}: non-finite field")
                z_got = (got - stats.mean_local_stress) / stats.std_local_stress
                z_ref = (ref - stats.mean_local_stress) / stats.std_local_stress
                err = np.abs(z_got - z_ref)
                share = float((err / (SERVE_ATOL + SERVE_RTOL * np.abs(z_ref))).max())
                worst, ratio = max(worst, float(err.max())), max(ratio, share)
                check(share <= 1.0, f"{impl} request {r}: {impl} vs xla max abs err "
                      f"{float(err.max()):.3e} (standardized) outside rtol={SERVE_RTOL} "
                      f"atol={SERVE_ATOL} ({share:.2f} of the allowance)")
            n_nodes = sum(s.num_nodes for s in samples)
            say(f"serve {impl} request {r}: {len(samples)} meshes, {n_nodes} nodes, latency "
                f"{latencies[r] * 1e3:.1f} ms (pack + forward + copy back), "
                f"{n_nodes / latencies[r]:.0f} nodes/s, {impl} vs xla max abs err "
                f"(standardized) {worst:.3e}, {ratio:.2f} of the allowance")
        results[impl] = {"launches": launches, "latencies": latencies}

    # device time of the model forward alone on request 0's batch, packed as
    # each path's Predictor packs it
    batches = {pair: pack_batch(requests[0], reorder="rcm", sender_view=False, div_ell=False,
                                pair_blocks=pair).to("cuda") for pair in (False, True)}
    with torch.no_grad():
        fwd = {name: cuda_ms(lambda m=m: m(batches[name == "fused2"], stats), 5)
               for name, m in models.items()}
    say("serve forward device time (request 0 batch): "
        + ", ".join(f"{name} {ms:.3f} ms" for name, ms in fwd.items()))
    return {"impls": results, "forward_ms": fwd}


def backward_kernel_phase(batch) -> dict:
    """Hold fused_edge_step3's backward kernel against its plain version at
    the training batch's shapes, with random inputs and nonzero cotangents
    on z_upd, R and M, in both stream dtypes; time both."""
    import torch

    from p_div_gnn_tpu_torch.ops.fused_edge3 import (
        fused_edge_step3_backward,
        fused_edge_step3_backward_reference,
        fused_edge_step3_reference,
    )

    dev = batch.receivers.device
    Np, Ep, L = batch.num_nodes_padded, batch.num_edges_padded, LATENT
    NB = int(batch.edge_block_tile.shape[0])
    real = batch.edge_mask.bool()
    e_real = int(real.sum())
    n_rcv = int(torch.unique(batch.receivers[real]).numel())
    gen = torch.Generator(device=dev).manual_seed(1)
    base = edge_step_inputs(batch, gen)
    dz, dr, dm = (torch.randn(shape, generator=gen, device=dev)
                  for shape in ((Ep, L), (Np, L), (8, L)))
    names = ("dx", "dg", "de", "dWu", "dWv", "dWe", "db0", "dW2", "db2")
    aux = (batch.edge_gid, batch.edge_block_tile)
    results = {}
    for sd_name, sd in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        args = [base[k].to(sd).contiguous() for k in base]
        z_upd, _, _ = fused_edge_step3_reference(*args, batch.receivers, batch.edge_gid,
                                                 batch.n_graphs)
        dz_sd = dz.to(sd)
        kern = lambda: fused_edge_step3_backward(  # noqa: E731
            *args, batch.receivers, aux, batch.n_graphs, batch.tile, z_upd, dz_sd, dr, dm)
        plain = lambda: fused_edge_step3_backward_reference(  # noqa: E731
            *args, batch.receivers, batch.edge_gid, batch.n_graphs, z_upd, dz_sd, dr, dm)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        checked = {n: held(f"fused_edge3_bwd {sd_name} {n}", a, b, BWD_TOL[sd_name])
                 for n, a, b in zip(names, got, want)}
        errs = {n: v[0] for n, v in checked.items()}
        del got, want
        s = torch.finfo(sd).bits // 8
        # reads x, g_x, e, z_upd, dz_upd, the weights (stream dtype), dR, dM
        # (fp32) and the indices; writes dg, de (stream dtype), dx and the
        # weight grads (fp32)
        n_bytes = (s * (Np * L + 6 * Ep * L + 4 * L * L + 2 * L)
                   + 4 * (2 * Np * L + 8 * L + (4 * L + 2) * L) + 4 * (2 * Ep + NB))
        # 20 products per real slot (6 recompute the forward, 7 form the data
        # cotangents, 7 the weight grads), of which x[r]·Wu and x[r]·Wv are
        # needed once per receiver
        flops = 2 * L * L * (18 * e_real + 2 * n_rcv)
        b_ms, b_by = bound(flops, n_bytes, sd_name)
        res = {"max_abs_err": max(errs.values()), "ms": cuda_ms(kern, 5),
               "plain_ms": cuda_ms(plain, 3), "bound_ms": b_ms, "bound_by": b_by}
        results[sd_name] = res
        say(f"kernel fused_edge3_bwd {sd_name}: Np={Np} Ep={Ep} L={L} blocks={NB} "
            f"real_edges={e_real} max_abs_err "
            + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
            + " share of the allowance "
            + " ".join(f"{k}={v[1]:.3f}" for k, v in checked.items())
            + f" kernel_ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by}: {flops / 1e9:.2f} GFLOP, {n_bytes / 1e9:.3f} GB)")
        torch.cuda.empty_cache()
    return results


def segment_sum_kernel_phase(batch) -> dict:
    """Hold the block-CSR segment sum against its plain version on the
    training batch's sender view in run order, as the sender gather's
    backward calls it (rows read through snd_run_perm); time both and
    ``index_add_``, the one PyTorch call that computes the same sums."""
    import torch

    from p_div_gnn_tpu_torch.ops.scatter_csr import csr_segment_sum, csr_segment_sum_reference

    dev = batch.receivers.device
    Np, Ep, L = batch.num_nodes_padded, batch.num_edges_padded, LATENT
    Ep2 = int(batch.snd_perm.shape[0])
    NB2 = int(batch.snd_block_tile.shape[0])
    gen = torch.Generator(device=dev).manual_seed(2)
    g = torch.randn((Ep, L), generator=gen, device=dev)
    snd = batch.senders.long()
    results = {}
    for sd_name, sd in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        rows = g.to(sd)
        kern = lambda: csr_segment_sum(  # noqa: E731
            rows, batch.snd_run_sorted, batch.snd_block_tile, Np, batch.tile,
            perm=batch.snd_run_perm)
        plain = lambda: csr_segment_sum_reference(  # noqa: E731
            rows, batch.snd_run_sorted, Np, batch.snd_run_perm)
        library = lambda: torch.zeros((Np, L), device=dev).index_add_(  # noqa: E731
            0, snd, rows.float())
        err = held(f"segment_sum_csr {sd_name}", kern(), plain(), CSR_TOL[sd_name])[0]
        narrow = rows[:, :18].contiguous()
        held(f"segment_sum_csr {sd_name} L=18",
             csr_segment_sum(narrow, batch.snd_run_sorted, batch.snd_block_tile, Np, batch.tile,
                             perm=batch.snd_run_perm),
             csr_segment_sum_reference(narrow, batch.snd_run_sorted, Np, batch.snd_run_perm),
             CSR_TOL[sd_name])
        # the JAX package's order of the same view splits a sender's slots
        # into several runs: the kernel must refuse it, not sum it wrongly
        try:
            csr_segment_sum(rows, batch.snd_sorted, batch.snd_block_tile, Np, batch.tile,
                            perm=batch.snd_perm)
            refused = False
        except ValueError:
            refused = True
        check(refused, f"segment_sum_csr {sd_name}: the view in the JAX package's order "
              "was summed, not refused")
        s = torch.finfo(sd).bits // 8
        # reads each source row once and the view's two indices per slot;
        # writes the sums
        n_bytes = s * Ep * L + 4 * 2 * Ep2 + 4 * Np * L
        b_ms, b_by = bound(Ep * L, n_bytes, sd_name)
        res = {"max_abs_err": err, "ms": cuda_ms(kern, 20), "plain_ms": cuda_ms(plain, 10),
               "library_ms": cuda_ms(library, 20), "bound_ms": b_ms, "bound_by": b_by}
        results[sd_name] = res
        say(f"kernel segment_sum_csr {sd_name}: Np={Np} Ep2={Ep2} L={L} blocks={NB2} "
            f"max_abs_err={err:.3e} kernel_ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f} "
            f"index_add_ms={res['library_ms']:.4f} bound_ms={b_ms:.4f} "
            f"({b_by}: {n_bytes / 1e9:.3f} GB)")
    return results


def v2_step_inputs(batch, gen, L: int = LATENT):
    """Random inputs of the v2 edge step at the batch's shapes: node
    projections a_u, a_v ~ N(0, 1) and their sender gathers g_v =
    a_v[senders], g_u = a_u[senders], e ~ N(0, 1), weights ~ N(0, 1/L),
    biases ~ N(0, 1); in the order of fused_edge_step's arguments."""
    import torch

    dev = batch.receivers.device
    Np, Ep = batch.num_nodes_padded, batch.num_edges_padded

    def randn(*shape: int, scale: float = 1.0) -> torch.Tensor:
        return torch.randn(shape, generator=gen, device=dev) * scale

    a_u, a_v = randn(Np, L), randn(Np, L)
    return {
        "a_u": a_u, "a_v": a_v,
        "g_v": a_v.index_select(0, batch.senders), "g_u": a_u.index_select(0, batch.senders),
        "e": randn(Ep, L), "w_e": randn(L, L, scale=L**-0.5), "b0": randn(L),
        "w2": randn(L, L, scale=L**-0.5), "b2": randn(L),
    }


# the sub-kernels of a v2 forward's launch (csrc/v2_fwd_tile.cuh,
# fwd_common.cuh): R's memset, the pair-blocked layout's zero rows, the fp32
# weight copy of the FMA kernel, the tile kernel (v2_... for #5, pair_...
# for #7), the moments reduce
V2_FWD_SUBS = ("Memset", "zero_z_rows_kernel", "copy_weights_kernel", "fwd_tile_fma_kernel",
               "fwd_tile_mma_kernel", "moments_reduce_kernel")


def v2_forward_held(name: str, sd_name: str, kern, plain) -> dict:
    """Hold a v2 forward (#5 or #7) against its plain version: two calls
    bit-equal, in fp32 z_upd bit-equal to the plain version, each output
    within KERNEL_TOL; print the sub-kernels' device times. Returns each
    output's (max abs err, share of the allowance)."""
    import torch

    got, again, want = kern(), kern(), plain()
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)), f"{name} {sd_name}: two calls differ")
    same = torch.equal(got[0], want[0])
    if sd_name == "float32":
        check(same, f"{name} float32: z_upd is not bit-equal to the plain version")
    checked = {n: held(f"{name} {sd_name} {n}", a, b, KERNEL_TOL[sd_name][n])
               for n, a, b in zip(("z_upd", "R", "M"), got, want)}
    del got, again, want
    split = sub_kernel_ms(kern, V2_FWD_SUBS)
    say(f"kernel {name} {sd_name} split: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in split.items() if v)
        + f"; two calls bit-equal; z_upd bit-equal to the plain version: {same}")
    return checked


def v2_kernel_phase(batch) -> dict:
    """Hold the v2 edge step's forward kernel (fused_edge_fwd) against its
    plain version on the card at the batch's shapes, in both stream dtypes
    (two calls bit-equal, fp32 z_upd bit-equal to the plain version); print
    its ptxas figures and sub-kernel times; time both."""
    import torch

    from p_div_gnn_tpu_torch.ops import cuda_build
    from p_div_gnn_tpu_torch.ops.fused_edge import (
        fused_edge_step,
        fused_edge_step_reference,
    )

    built = cuda_build.library("fused_edge_fwd")
    for fig in ptxas_figures(built, built.lib.pdg_fused_edge_fwd_smem):
        say(f"kernel fused_edge_fwd ptxas: {fig}")
    say(f"kernel fused_edge_fwd: {built.lib.pdg_fused_edge_fwd_parts()} parts "
        "(one CTA per SM)")
    dev = batch.receivers.device
    Np, Ep, L = batch.num_nodes_padded, batch.num_edges_padded, LATENT
    NB = int(batch.edge_block_tile.shape[0])
    e_real = int(batch.edge_mask.sum())
    base = v2_step_inputs(batch, torch.Generator(device=dev).manual_seed(3))
    aux = (batch.edge_gid, batch.edge_block_tile)
    results = {}
    for sd_name, sd in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        args = [base[k].to(sd).contiguous() for k in base]
        kern = lambda: fused_edge_step(  # noqa: E731
            *args, batch.receivers, aux, batch.n_graphs, batch.tile)
        plain = lambda: fused_edge_step_reference(  # noqa: E731
            *args, batch.receivers, batch.edge_gid, batch.n_graphs)
        checked = v2_forward_held("fused_edge_fwd", sd_name, kern, plain)
        s = torch.finfo(sd).bits // 8
        # reads a_u, a_v, the weights (stream dtype), g_v, g_u and e of the
        # real slots (a padding slot's rows change no output) and the
        # indices; writes z_upd over all slots (stream dtype), R and M (fp32)
        n_bytes = (s * (2 * Np * L + 3 * e_real * L + Ep * L + 2 * L * L + 2 * L)
                   + 4 * (2 * Ep + NB) + 4 * (Np * L + 8 * L))
        flops = 2 * 3 * L * L * e_real
        b_ms, b_by = bound(flops, n_bytes, sd_name)
        res = {"max_abs_err": max(v[0] for v in checked.values()),
               "ms": cuda_ms(kern, 20), "plain_ms": cuda_ms(plain, 10),
               "bound_ms": b_ms, "bound_by": b_by}
        results[sd_name] = res
        say(f"kernel fused_edge_fwd {sd_name}: Np={Np} Ep={Ep} L={L} blocks={NB} "
            f"real_edges={e_real} max_abs_err "
            + " ".join(f"{k}={v[0]:.3e}" for k, v in checked.items())
            + " share of the allowance "
            + " ".join(f"{k}={v[1]:.3f}" for k, v in checked.items())
            + f" kernel_ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by}: {flops / 1e9:.2f} GFLOP, {n_bytes / 1e9:.3f} GB)")
    return results


def v2_backward_kernel_phase(batch) -> dict:
    """Hold the v2 edge step's backward kernel (fused_edge_bwd) against its
    plain version at the training batch's shapes, with random inputs and
    nonzero cotangents on z_upd, R and M, in both stream dtypes; time both."""
    import torch

    from p_div_gnn_tpu_torch.ops import cuda_build
    from p_div_gnn_tpu_torch.ops.fused_edge import (
        fused_edge_step_backward,
        fused_edge_step_backward_reference,
        fused_edge_step_reference,
    )

    built = cuda_build.library("fused_edge_bwd")
    for fig in ptxas_figures(built, built.lib.pdg_fused_edge_bwd_smem):
        say(f"kernel fused_edge_bwd ptxas: {fig}")
    dev = batch.receivers.device
    Np, Ep, L = batch.num_nodes_padded, batch.num_edges_padded, LATENT
    NB = int(batch.edge_block_tile.shape[0])
    e_real = int(batch.edge_mask.sum())
    gen = torch.Generator(device=dev).manual_seed(4)
    base = v2_step_inputs(batch, gen)
    dz, dr, dm = (torch.randn(shape, generator=gen, device=dev)
                  for shape in ((Ep, L), (Np, L), (8, L)))
    names = ("da_u", "da_v", "dg_v", "dg_u", "de", "dWe", "db0", "dW2", "db2")
    aux = (batch.edge_gid, batch.edge_block_tile)
    results = {}
    for sd_name, sd in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        args = [base[k].to(sd).contiguous() for k in base]
        z_upd, _, _ = fused_edge_step_reference(*args, batch.receivers, batch.edge_gid,
                                                batch.n_graphs)
        dz_sd = dz.to(sd)
        kern = lambda: fused_edge_step_backward(  # noqa: E731
            *args, batch.receivers, aux, batch.n_graphs, batch.tile, z_upd, dz_sd, dr, dm)
        plain = lambda: fused_edge_step_backward_reference(  # noqa: E731
            *args, batch.receivers, batch.edge_gid, batch.n_graphs, z_upd, dz_sd, dr, dm)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        checked = {n: held(f"fused_edge_bwd {sd_name} {n}", a, b, BWD_TOL[sd_name])
                   for n, a, b in zip(names, got, want)}
        del got, want
        s = torch.finfo(sd).bits // 8
        # reads a_u, a_v, g_v, g_u, e, z_upd, dz_upd, the weights (stream
        # dtype), dR, dM (fp32) and the indices; writes dg_v, dg_u, de
        # (stream dtype), da_u, da_v and the weight grads (fp32)
        n_bytes = (s * (2 * Np * L + 8 * Ep * L + 2 * L * L + 2 * L)
                   + 4 * (3 * Np * L + 8 * L + (2 * L + 2) * L) + 4 * (2 * Ep + NB))
        flops = 2 * 8 * L * L * e_real
        b_ms, b_by = bound(flops, n_bytes, sd_name)
        res = {"max_abs_err": max(v[0] for v in checked.values()), "ms": cuda_ms(kern, 5),
               "plain_ms": cuda_ms(plain, 3), "bound_ms": b_ms, "bound_by": b_by}
        results[sd_name] = res
        split = sub_kernel_ms(kern, ("v2_bwd_tile_kernel", "bwd_wgrad_kernel",
                                     "bwd_reduce_kernel", "prepare_weights_kernel"))
        say(f"kernel fused_edge_bwd {sd_name} split: "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in split.items()))
        say(f"kernel fused_edge_bwd {sd_name}: Np={Np} Ep={Ep} L={L} blocks={NB} "
            f"real_edges={e_real} max_abs_err "
            + " ".join(f"{k}={v[0]:.3e}" for k, v in checked.items())
            + " share of the allowance "
            + " ".join(f"{k}={v[1]:.3f}" for k, v in checked.items())
            + f" kernel_ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by}: {flops / 1e9:.2f} GFLOP, {n_bytes / 1e9:.3f} GB)")
        torch.cuda.empty_cache()
    return results


def pair_kernel_phase(batch, view: str) -> dict:
    """Hold the pair segment sum (#4) against its plain version on
    ``batch``'s sender view in run order, as the path named ``view`` calls
    it with two streams read through snd_run_perm: the pair sender gather's
    backward (fused) on the receiver-major training batch, the sender-side
    adds of dpre1 / dpre2 (fused2) on the pair-blocked one; fp32 and bf16
    rows, read as stored (two calls bit-equal), and once at L = 18. Time
    both and two ``index_add_`` calls (the PyTorch calls that compute the
    same sums)."""
    import torch

    from p_div_gnn_tpu_torch.ops.scatter_csr import (
        csr_segment_sum_pair,
        csr_segment_sum_pair_reference,
    )

    dev = batch.receivers.device
    Np, Ep, L = batch.num_nodes_padded, batch.num_edges_padded, LATENT
    Ep2 = int(batch.snd_perm.shape[0])
    NB2 = int(batch.snd_block_tile.shape[0])
    # the rows that change an output: a slot of the view whose sender is a
    # node (not -1) and whose source slot holds a real edge (a padding
    # edge's cotangent rows are zero: the least work skips them)
    real = int(((batch.snd_run_sorted >= 0)
                & (batch.edge_gid[batch.snd_run_perm.long()] < batch.n_graphs)).sum())
    gen = torch.Generator(device=dev).manual_seed(5)
    base = [torch.randn((Ep, L), generator=gen, device=dev) for _ in range(2)]
    snd = batch.senders.long()
    view_idx = (batch.snd_run_sorted, batch.snd_block_tile, Np, batch.tile)
    results = {}
    for sd_name, sd in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        g_v, g_u = (t.to(sd) for t in base)
        kern = lambda: csr_segment_sum_pair(  # noqa: E731
            g_v, g_u, *view_idx, perm=batch.snd_run_perm)
        plain = lambda: csr_segment_sum_pair_reference(  # noqa: E731
            g_v, g_u, batch.snd_run_sorted, Np, batch.snd_run_perm)
        library = lambda: tuple(  # noqa: E731
            torch.zeros((Np, L), device=dev).index_add_(0, snd, g.float()) for g in (g_v, g_u))
        got, again, want = kern(), kern(), plain()
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"segment_sum_csr_pair {sd_name} {view}: two calls differ")
        checked = [held(f"segment_sum_csr_pair {sd_name} {view} {n}", x, y, CSR_TOL[sd_name])
                   for n, x, y in zip(("out_v", "out_u"), got, want)]
        narrow = [t[:, :18].contiguous() for t in (g_v, g_u)]
        held(f"segment_sum_csr_pair {sd_name} {view} L=18",
             csr_segment_sum_pair(*narrow, *view_idx, perm=batch.snd_run_perm)[0],
             csr_segment_sum_pair_reference(*narrow, batch.snd_run_sorted, Np,
                                            batch.snd_run_perm)[0], CSR_TOL[sd_name])
        del got, again, want
        s = torch.finfo(sd).bits // 8
        # reads the real rows of both streams once and the view's two
        # indices per slot; writes both sums
        n_bytes = 2 * s * real * L + 4 * 2 * Ep2 + 2 * 4 * Np * L
        b_ms, b_by = bound(2 * real * L, n_bytes, sd_name)
        res = {"max_abs_err": max(c[0] for c in checked), "ms": cuda_ms(kern, 20),
               "plain_ms": cuda_ms(plain, 10), "library_ms": cuda_ms(library, 20),
               "bound_ms": b_ms, "bound_by": b_by, "Ep2": Ep2, "real_rows": real}
        results[sd_name] = res
        say(f"kernel segment_sum_csr_pair {sd_name} {view}: Np={Np} Ep2={Ep2} real_rows={real} "
            f"L={L} blocks={NB2} max_abs_err={res['max_abs_err']:.3e} share of the allowance "
            + " ".join(f"{c[1]:.3f}" for c in checked)
            + f" kernel_ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f} "
            f"two_index_add_ms={res['library_ms']:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by}: {n_bytes / 1e9:.3f} GB), share of the bound "
            f"{b_ms / res['ms']:.3f}; two calls bit-equal")
        torch.cuda.empty_cache()
    return results


def mgn_edge_kernel_phase(batch) -> dict:
    """Hold MeshGraphNets' edge update kernel (``mgn_edge_fwd``) against its
    plain version on the card over the batch's live slots at L = 128, with
    random rows and weights (two calls bit-equal); time both."""
    import torch

    from p_div_gnn_tpu_torch.models import meshgraphnets as mgn
    from p_div_gnn_tpu_torch.ops import mgn_edge

    dev = batch.receivers.device
    edges = mgn.live_edges(batch)
    n, Np, L = edges.n, batch.num_nodes_padded, mgn_edge.WIDTH
    gen = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s, scale=1.0: torch.randn(*s, generator=gen, device=dev) * scale  # noqa: E731
    w = lambda: rnd(L, L, scale=L**-0.5)  # noqa: E731
    args = (rnd(Np, L), rnd(Np, L), rnd(n, L), w(), rnd(L), (w(), rnd(L), w(), rnd(L)),
            1 + rnd(L, scale=0.1), rnd(L, scale=0.1), edges.mask.float()[:, None],
            edges.senders, edges.receivers)
    kern = lambda: mgn_edge._edge_update_cuda(*args, saves=True)  # noqa: E731
    plain = lambda: mgn_edge.edge_update_reference(*args)  # noqa: E731
    flat = lambda out: (out[0], out[1], *out[2])  # noqa: E731
    got, again, want = flat(kern()), flat(kern()), flat(plain())
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)), "mgn_edge_fwd: two calls differ")
    names = ("e_new", "e_sum", "a0", "a1", "y", "mean", "rstd")
    checked = {k: held(f"mgn_edge_fwd {k}", a, b, MGN_EDGE_TOL)
               for k, a, b in zip(names, got, want)}
    del got, again, want
    # three L x L products a slot, each run as six bf16 products (bf16x6);
    # read e and, once each through L2, the two projections; written a0, a1,
    # y, e', e + e' and two row statistics
    flops = 3 * 2 * n * L * L
    n_bytes = 4 * (6 * n * L + 2 * Np * L + 5 * n)
    b_ms, b_by = bound(6 * flops, n_bytes, "bfloat16")
    res = {"max_abs_err": max(v[0] for v in checked.values()), "ms": cuda_ms(kern, 20),
           "plain_ms": cuda_ms(plain, 10), "bound_ms": b_ms, "bound_by": b_by}
    say(f"kernel mgn_edge_fwd float32: n={n} Np={Np} L={L} max abs err "
        + " ".join(f"{k}={v[0]:.3e}" for k, v in checked.items())
        + " share of the allowance " + " ".join(f"{k}={v[1]:.3f}" for k, v in checked.items())
        + f" kernel_ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f} "
        f"bound_ms={b_ms:.4f} ({b_by}: {flops / 1e9:.2f} GFLOP, {n_bytes / 1e9:.3f} GB), "
        f"share of the bound {b_ms / res['ms']:.3f}; two calls bit-equal")
    torch.cuda.empty_cache()
    return res


def pair_step_inputs(batch, gen, L: int = LATENT):
    """Random inputs of the fused2 edge step at the pair-blocked batch's
    shapes: node projections proj_u, proj_v ~ N(0, 1), e ~ N(0, 1), weights
    ~ N(0, 1/L), biases ~ N(0, 1); in the order of fused_edge_step2's
    arguments."""
    import torch

    dev = batch.receivers.device
    Np, Ep = batch.num_nodes_padded, batch.num_edges_padded

    def randn(*shape: int, scale: float = 1.0) -> torch.Tensor:
        return torch.randn(shape, generator=gen, device=dev) * scale

    return {
        "proj_u": randn(Np, L), "proj_v": randn(Np, L), "e": randn(Ep, L),
        "w_e": randn(L, L, scale=L**-0.5), "b0": randn(L),
        "w2": randn(L, L, scale=L**-0.5), "b2": randn(L),
    }


def pair_aux(batch) -> tuple:
    return (batch.edge_gid, batch.edge_block_tile, batch.edge_block_snd_tile,
            batch.snd_run_perm, batch.snd_run_sorted, batch.snd_block_tile)


def fused2_kernel_phase(batch) -> dict:
    """Hold the fused2 edge step's forward kernel (fused_edge2_fwd) against
    its plain version on the card at the pair-blocked batch's shapes, in
    both stream dtypes (two calls bit-equal, fp32 z_upd bit-equal to the
    plain version); print its ptxas figures and sub-kernel times; time
    both."""
    import torch

    from p_div_gnn_tpu_torch.ops import cuda_build
    from p_div_gnn_tpu_torch.ops.fused_edge import (
        fused_edge_step2,
        fused_edge_step2_reference,
    )

    built = cuda_build.library("fused_edge2_fwd")
    for fig in ptxas_figures(built, built.lib.pdg_fused_edge2_fwd_smem):
        say(f"kernel fused_edge2_fwd ptxas: {fig}")
    dev = batch.receivers.device
    Np, Ep, L = batch.num_nodes_padded, batch.num_edges_padded, LATENT
    NB = int(batch.edge_block_tile.shape[0])
    e_real = int(batch.edge_mask.sum())
    base = pair_step_inputs(batch, torch.Generator(device=dev).manual_seed(6))
    aux = pair_aux(batch)
    idx = (batch.receivers, batch.senders, aux, batch.n_graphs, batch.tile)
    results = {}
    for sd_name, sd in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        args = [base[k].to(sd).contiguous() for k in base]
        kern = lambda: fused_edge_step2(*args, *idx)  # noqa: E731
        plain = lambda: fused_edge_step2_reference(*args, *idx)  # noqa: E731
        checked = v2_forward_held("fused_edge2_fwd", sd_name, kern, plain)
        s = torch.finfo(sd).bits // 8
        # reads proj_u, proj_v, the weights (stream dtype), e of the real
        # slots (a padding slot's row changes no output), the three index
        # arrays and the two block-tile arrays; writes z_upd over all slots
        # (stream dtype), R and M (fp32)
        n_bytes = (s * (2 * Np * L + e_real * L + Ep * L + 2 * L * L + 2 * L)
                   + 4 * (3 * Ep + 2 * NB) + 4 * (Np * L + 8 * L))
        flops = 2 * 3 * L * L * e_real
        b_ms, b_by = bound(flops, n_bytes, sd_name)
        res = {"max_abs_err": max(v[0] for v in checked.values()),
               "ms": cuda_ms(kern, 20), "plain_ms": cuda_ms(plain, 5),
               "bound_ms": b_ms, "bound_by": b_by}
        results[sd_name] = res
        say(f"kernel fused_edge2_fwd {sd_name}: Np={Np} Ep={Ep} L={L} blocks={NB} "
            f"real_edges={e_real} max_abs_err "
            + " ".join(f"{k}={v[0]:.3e}" for k, v in checked.items())
            + " share of the allowance "
            + " ".join(f"{k}={v[1]:.3f}" for k, v in checked.items())
            + f" kernel_ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by}: {flops / 1e9:.2f} GFLOP, {n_bytes / 1e9:.3f} GB)")
        torch.cuda.empty_cache()
    return results


def fused2_backward_kernel_phase(batch) -> dict:
    """Hold the fused2 edge step's backward kernel (fused_edge2_bwd, before
    the sender-side pair sum) against its plain version at the pair-blocked
    training batch's shapes, with random inputs and nonzero cotangents on
    z_upd, R and M, in both stream dtypes; time both."""
    import torch

    from p_div_gnn_tpu_torch.ops import cuda_build
    from p_div_gnn_tpu_torch.ops.fused_edge import (
        fused_edge2_bwd,
        fused_edge2_bwd_reference,
        fused_edge_step2_reference,
    )

    built = cuda_build.library("fused_edge2_bwd")
    for fig in ptxas_figures(built, built.lib.pdg_fused_edge2_bwd_smem):
        say(f"kernel fused_edge2_bwd ptxas: {fig}")
    dev = batch.receivers.device
    Np, Ep, L = batch.num_nodes_padded, batch.num_edges_padded, LATENT
    NB = int(batch.edge_block_tile.shape[0])
    e_real = int(batch.edge_mask.sum())
    gen = torch.Generator(device=dev).manual_seed(7)
    base = pair_step_inputs(batch, gen)
    dz, dr, dm = (torch.randn(shape, generator=gen, device=dev)
                  for shape in ((Ep, L), (Np, L), (8, L)))
    names = ("de", "dpre1", "dpre2", "du_r", "dv_r", "dWe", "db0", "dW2", "db2")
    idx = (batch.receivers, batch.senders, pair_aux(batch), batch.n_graphs, batch.tile)
    results = {}
    for sd_name, sd in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        args = [base[k].to(sd).contiguous() for k in base]
        z_upd, _, _ = fused_edge_step2_reference(*args, *idx)
        cots = (z_upd, dz.to(sd), dr, dm)
        kern = lambda: fused_edge2_bwd(*args, *idx, *cots)  # noqa: E731
        plain = lambda: fused_edge2_bwd_reference(*args, *idx, *cots)  # noqa: E731
        got, want = kern(), plain()
        torch.cuda.synchronize()
        checked = {n: held(f"fused_edge2_bwd {sd_name} {n}", a, b, BWD_TOL[sd_name])
                   for n, a, b in zip(names, got, want)}
        del got, want
        s = torch.finfo(sd).bits // 8
        # reads proj_u, proj_v, the weights (stream dtype), e, z_upd and
        # dz_upd of the real slots (a padding slot's rows change no output),
        # dR, dM (fp32) and the indices; writes de, dpre1, dpre2 over all
        # slots (stream dtype), du_r, dv_r and the weight grads (fp32)
        n_bytes = (s * (2 * Np * L + 3 * e_real * L + 3 * Ep * L + 2 * L * L + 2 * L)
                   + 4 * (3 * Np * L + 8 * L + (2 * L + 2) * L) + 4 * (3 * Ep + 2 * NB))
        flops = 2 * 8 * L * L * e_real
        b_ms, b_by = bound(flops, n_bytes, sd_name)
        res = {"max_abs_err": max(v[0] for v in checked.values()), "ms": cuda_ms(kern, 5),
               "plain_ms": cuda_ms(plain, 3), "bound_ms": b_ms, "bound_by": b_by}
        results[sd_name] = res
        split = sub_kernel_ms(kern, ("pair_bwd_tile_kernel", "bwd_wgrad_kernel",
                                     "bwd_reduce_kernel", "zero_rows_kernel",
                                     "prepare_weights_kernel"))
        say(f"kernel fused_edge2_bwd {sd_name} split: "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in split.items()))
        say(f"kernel fused_edge2_bwd {sd_name}: Np={Np} Ep={Ep} L={L} blocks={NB} "
            f"real_edges={e_real} max_abs_err "
            + " ".join(f"{k}={v[0]:.3e}" for k, v in checked.items())
            + " share of the allowance "
            + " ".join(f"{k}={v[1]:.3f}" for k, v in checked.items())
            + f" kernel_ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by}: {flops / 1e9:.2f} GFLOP, {n_bytes / 1e9:.3f} GB)")
        del z_upd, cots
        torch.cuda.empty_cache()
    return results


# the width phase: every fused kernel at a width its tiles are not laid out
# for (16, through the zero padding), at the widest they are (256) and at
# two widths of the wide variant (320, 512), on a cut batch
WIDTHS = (16, 256, 320, 512)
WIDE_LATENT = 384  # the fused3 train step of the width phase
WIDTH_MESHES = 2


def width_phase() -> dict:
    """Hold each fused kernel (#1, #2, #5-#8) against its plain version once
    at each of WIDTHS, in both stream dtypes, with random inputs and
    nonzero cotangents, on a batch of WIDTH_MESHES meshes (receiver-major
    and pair-blocked), at the JAX op tolerances; time each call at L = 512
    (fp32). Then one fp32 fused3 train step at WIDE_LATENT on the
    receiver-major batch against xla. Returns the L = 512 times."""
    import torch

    from p_div_gnn_tpu_torch.datagen.workload import build_workload
    from p_div_gnn_tpu_torch.ops import cuda_build, fused_edge, fused_edge3

    batch = build_workload(WIDTH_MESHES, seed=0)[0].to("cuda")
    pair = build_workload(WIDTH_MESHES, seed=0, pair_blocks=True)[0].to("cuda")
    gen = torch.Generator(device="cuda").manual_seed(11)
    rcv, gid, n_graphs, tile = batch.receivers, batch.edge_gid, batch.n_graphs, batch.tile
    rm = (rcv, (gid, batch.edge_block_tile), n_graphs, tile)
    pidx = (pair.receivers, pair.senders, pair_aux(pair), pair.n_graphs, pair.tile)
    wide_ms = {}
    for L in WIDTHS:
        for sd_name, sd in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            def cast(d):
                return [t.to(sd).contiguous() for t in d.values()]

            f3 = cast(edge_step_inputs(batch, gen, L))
            v2 = cast(v2_step_inputs(batch, gen, L))
            p2 = cast(pair_step_inputs(pair, gen, L))

            def cots(b, z):
                return (z, torch.randn(z.shape, generator=gen, device="cuda").to(sd),
                        torch.randn((b.num_nodes_padded, L), generator=gen, device="cuda"),
                        torch.randn((8, L), generator=gen, device="cuda"))

            c3 = cots(batch, fused_edge3.fused_edge_step3_reference(*f3, rcv, gid, n_graphs)[0])
            cv = cots(batch, fused_edge.fused_edge_step_reference(*v2, rcv, gid, n_graphs)[0])
            cp = cots(pair, fused_edge.fused_edge_step2_reference(*p2, *pidx)[0])
            fwd = tuple(KERNEL_TOL[sd_name].values())
            bwd = (BWD_TOL[sd_name],) * 9
            cases = {
                "fused_edge3_fwd": (lambda: fused_edge3.fused_edge_step3(*f3, *rm),
                                    lambda: fused_edge3.fused_edge_step3_reference(
                                        *f3, rcv, gid, n_graphs), fwd),
                "fused_edge3_bwd": (lambda: fused_edge3.fused_edge_step3_backward(
                                        *f3, *rm, *c3),
                                    lambda: fused_edge3.fused_edge_step3_backward_reference(
                                        *f3, rcv, gid, n_graphs, *c3), bwd),
                "fused_edge_fwd": (lambda: fused_edge.fused_edge_step(*v2, *rm),
                                   lambda: fused_edge.fused_edge_step_reference(
                                       *v2, rcv, gid, n_graphs), fwd),
                "fused_edge_bwd": (lambda: fused_edge.fused_edge_step_backward(*v2, *rm, *cv),
                                   lambda: fused_edge.fused_edge_step_backward_reference(
                                       *v2, rcv, gid, n_graphs, *cv), bwd),
                "fused_edge2_fwd": (lambda: fused_edge.fused_edge_step2(*p2, *pidx),
                                    lambda: fused_edge.fused_edge_step2_reference(*p2, *pidx),
                                    fwd),
                "fused_edge2_bwd": (lambda: fused_edge.fused_edge2_bwd(*p2, *pidx, *cp),
                                    lambda: fused_edge.fused_edge2_bwd_reference(
                                        *p2, *pidx, *cp), bwd),
            }
            for name, (kern, plain, tols) in cases.items():
                before = cuda_build.launches[name]
                got = kern()
                check(cuda_build.launches[name] == before + 1, f"width {name}: no launch")
                want = plain()
                torch.cuda.synchronize()
                shares = [held(f"width {name} {sd_name} L={L} output {i}", a, b, tol)[1]
                          for i, (a, b, tol) in enumerate(zip(got, want, tols, strict=True))]
                timed = ""
                if L == max(WIDTHS):
                    check(all(torch.equal(a, b) for a, b in zip(got, kern())),
                          f"width {name} {sd_name} L={L}: two calls differ")
                    wide_ms[f"{name} {sd_name}"] = ms = cuda_ms(kern, 3)
                    timed = f", two calls bit-equal, kernel_ms={ms:.4f}"
                say(f"width {name} {sd_name} L={L}: {len(shares)} outputs held, largest share "
                    f"of the allowance {max(shares):.3f}{timed}")
                del got, want
            torch.cuda.empty_cache()
    say(f"width phase batch: Np={batch.num_nodes_padded} Ep={batch.num_edges_padded}; "
        f"pair-blocked Ep={pair.num_edges_padded}")
    wide_train_step(batch)
    return wide_ms


def wide_train_step(batch) -> None:
    """One fp32 fused3 train step at WIDE_LATENT (the wide variant of #1
    and #2; #3 at that width) against xla from the same init: the step-1
    loss within LOSS_RTOL, each parameter's gradient within GRAD_RTOL, and
    the fused3 step's launches."""
    import torch

    grads, losses = {}, {}
    for impl in ("fused3", "xla"):
        trainer = make_trainer(impl, "float32", "cuda", latent=WIDE_LATENT)
        reset_launch_counts()
        aux, g = trainer.loss_and_grads(batch)
        launches = {k: v for k, v in launch_counts().items() if v}
        want = {"fused3": {"fused_edge3_fwd": STEPS, "fused_edge3_bwd": STEPS,
                           "segment_sum_csr": STEPS}, "xla": {}}[impl]
        check(launches == want, f"wide train {impl}: launches {launches}, expected {want}")
        losses[impl] = float(aux["total"])
        grads[impl] = {n: t.detach().clone() for n, t in g.items()}
        del trainer
    l_f, l_x = losses["fused3"], losses["xla"]
    check(abs(l_f - l_x) <= LOSS_RTOL * abs(l_x),
          f"wide train step: fused3 loss {l_f!r} vs xla {l_x!r} outside rtol {LOSS_RTOL}")
    rel = {n: float(torch.linalg.vector_norm(grads["fused3"][n].double() - g.double())
                    / torch.linalg.vector_norm(g.double()).clamp_min(1e-300))
           for n, g in grads["xla"].items()}
    worst = max(rel, key=rel.get)
    check(all(bool(torch.isfinite(g).all()) for g in grads["fused3"].values()),
          "wide train step: non-finite fused3 gradients")
    check(rel[worst] <= GRAD_RTOL,
          f"wide train step: gradient of {worst} fused3 vs xla {rel[worst]:.3e} > {GRAD_RTOL:g}")
    say(f"wide train step L={WIDE_LATENT}: loss fused3 {l_f!r} xla {l_x!r} (rel "
        f"{abs(l_f - l_x) / abs(l_x):.3e}); gradients ||fused3 - xla|| / ||xla|| max "
        f"{rel[worst]:.3e} ({worst}), tolerance {GRAD_RTOL:g}")
    torch.cuda.empty_cache()


# the kernels whose launches the phases hold (cuda_build.launches' keys)
KERNELS = ("fused_edge3_fwd", "fused_edge3_bwd", "segment_sum_csr", "fused_edge_fwd",
           "fused_edge_bwd", "segment_sum_csr_pair", "fused_edge2_fwd", "fused_edge2_bwd",
           "mgn_edge_fwd")


def launch_counts() -> dict:
    from p_div_gnn_tpu_torch.ops import cuda_build

    return {name: cuda_build.launches[name] for name in KERNELS}


def reset_launch_counts() -> None:
    from p_div_gnn_tpu_torch.ops import cuda_build

    cuda_build.launches.clear()


def make_trainer(impl: str, stream_dtype: str, device, latent: int = LATENT, group=None):
    """The benchmark's model and trainer (bench.py:166-178) from a seeded
    random init, on ``device``: the same weights for every impl and dtype
    (at ``latent``, LATENT unless the width phase asks another); ``group``:
    data parallelism over those ranks."""
    import torch

    from p_div_gnn_tpu_torch.graphs.container import NormStats
    from p_div_gnn_tpu_torch.models.epd import EncodeProcessDecode
    from p_div_gnn_tpu_torch.train.loop import Trainer

    model = EncodeProcessDecode(
        latent_size=latent, message_passing_steps=STEPS, scatter_impl=impl,
        stream_dtype=stream_dtype, generator=torch.Generator().manual_seed(0),
        remat_steps=False,
    )
    trainer = Trainer(model, NormStats.ones(), learning_rate=LEARNING_RATE,
                      divergence_penalty=DIV_PENALTY, optimize_divergence=True, device=device,
                      group=group)
    trainer.init()
    return trainer


def train_run(impl: str, stream_dtype: str, batch, n_real_edges: int,
              n_steps: int = TRAIN_STEPS) -> dict:
    """``n_steps`` calls of Trainer.train_step, with the launch counts set to
    0 just before and read just after; each step timed with CUDA events and
    its kernel launches held to its path's. Returns the losses, the step-1
    gradients, the times and the run's launches."""
    import torch

    trainer = make_trainer(impl, stream_dtype, batch.receivers.device)
    name = f"train {impl} {stream_dtype}"
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    per_step = {k: step_launches(impl).get(k, 0) for k in launch_counts()}
    losses, step_ms, grads = [], [], None
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    for step in range(n_steps):
        before = launch_counts()
        start.record()
        aux = trainer.train_step(batch)
        stop.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(stop))
        delta = {k: v - before[k] for k, v in launch_counts().items()}
        check(delta == per_step,
              f"{name} step {step + 1}: kernel launches {delta}, expected {per_step}")
        loss = float(aux["total"])
        check(all(bool(torch.isfinite(v)) for v in aux.values()),
              f"{name} step {step + 1}: non-finite loss {loss}")
        if step == 0:
            # train_step leaves the step's gradients in .grad (Adam reads them)
            grads = {n: p.grad.detach().clone() for n, p in trainer.model.named_parameters()}
            bad = [n for n, gr in grads.items() if not bool(torch.isfinite(gr).all())]
            check(not bad, f"{name}: non-finite gradients in {bad}")
        losses.append(loss)
    launches = launch_counts()
    steady = statistics.median(step_ms[1:] or step_ms)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    say(f"{name}: losses " + " ".join(f"{v:.6f}" for v in losses)
        + ", step ms " + " ".join(f"{v:.1f}" for v in step_ms)
        + f", median of steps {min(2, n_steps)}-{n_steps} {steady:.3f} ms, "
        f"{n_real_edges / steady * 1e3:.0f} edges/s, peak memory {peak_gb:.2f} GB, "
        "launches per step "
        + (", ".join(f"{k} {v}" for k, v in per_step.items() if v) or "none"))
    return {"trainer": trainer, "losses": losses, "grads": grads, "step_ms": steady,
            "launches": launches, "peak_gb": peak_gb}


def step_breakdown(trainer, batch, name: str) -> list[float]:
    """Where the time of one step goes: forward + loss, backward, Adam (one
    more step of the trainer, outside the counted runs)."""
    import torch

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    trainer.model.zero_grad(set_to_none=True)
    ev[0].record()
    total, _ = trainer.loss(batch)
    ev[1].record()
    total.backward()
    ev[2].record()
    trainer.optimizer.step()
    ev[3].record()
    torch.cuda.synchronize()
    parts = [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
    say(f"train {name} step breakdown: forward+loss {parts[0]:.3f} ms, "
        f"backward {parts[1]:.3f} ms, Adam {parts[2]:.3f} ms")
    return parts


# (impl, stream dtype, steps) of the train phase, in order; xla fp32 is the
# reference of every other fp32 impl
TRAIN_RUNS = (
    ("fused3", "float32", TRAIN_STEPS), ("xla", "float32", TRAIN_STEPS),
    ("fused3", "bfloat16", TRAIN_STEPS), ("fused", "float32", TRAIN_STEPS),
    ("fused", "bfloat16", TRAIN_STEPS), ("fused2", "float32", TRAIN_STEPS),
    ("fused2", "bfloat16", TRAIN_STEPS), ("pallas", "float32", 3), ("hybrid", "float32", 3),
)
# the impls whose bf16 run is held against their fp32 run
BF16_IMPLS = ("fused3", "fused", "fused2")


def train_phase(batch, pair_batch, n_real_edges: int, card: str) -> dict:
    """The TRAIN_RUNS from the same init (fused2 on ``pair_batch``, the same
    meshes packed pair-blocked); each fp32 impl is held against xla at step
    1, each bf16 run against its fp32 run, and the kernel launches of each
    run are returned. ``card`` is nvidia-smi's name and power limit, printed
    beside the step times."""
    import torch

    runs, breakdown = {}, {}
    for impl, sd, n_steps in TRAIN_RUNS:
        b = pair_batch if impl == "fused2" else batch
        run = train_run(impl, sd, b, n_real_edges, n_steps)
        if sd == "float32" and impl in BF16_IMPLS:
            breakdown[impl] = step_breakdown(run["trainer"], b, f"{impl} {sd}")
        del run["trainer"]
        runs[(impl, sd)] = run
        torch.cuda.empty_cache()

    x32 = runs[("xla", "float32")]
    l_x = x32["losses"][0]
    for (impl, sd), run in runs.items():
        if impl == "xla" or sd != "float32":
            continue
        l_f = run["losses"][0]
        check(abs(l_f - l_x) <= LOSS_RTOL * abs(l_x),
              f"train step 1: {impl} loss {l_f!r} vs xla {l_x!r} outside rtol {LOSS_RTOL}")
        rel = {}
        for n, g_x in x32["grads"].items():
            d = torch.linalg.vector_norm(run["grads"][n].double() - g_x.double())
            rel[n] = float(d / torch.linalg.vector_norm(g_x.double()).clamp_min(1e-300))
        worst = max(rel, key=rel.get)
        say(f"train step 1: loss {impl} {l_f!r} xla {l_x!r} (rel {abs(l_f - l_x) / abs(l_x):.3e}); "
            f"gradients ||{impl} - xla|| / ||xla|| max {rel[worst]:.3e} ({worst}), "
            f"median {statistics.median(rel.values()):.3e}, tolerance {GRAD_RTOL:g}")
        check(rel[worst] <= GRAD_RTOL,
              f"train step 1: gradient of {worst} {impl} vs xla {rel[worst]:.3e} > {GRAD_RTOL:g}")
    for key in (("fused3", "float32"), ("xla", "float32"), ("fused", "float32"),
                ("fused", "bfloat16"), ("fused2", "float32"), ("fused2", "bfloat16")):
        run = runs[key]
        check(run["losses"][-1] < run["losses"][0],
              f"train {' '.join(key)}: step-{TRAIN_STEPS} loss {run['losses'][-1]} is not "
              f"below step-1 loss {run['losses'][0]}")
    for impl in BF16_IMPLS:
        l_b, l_f = runs[(impl, "bfloat16")]["losses"][0], runs[(impl, "float32")]["losses"][0]
        check(abs(l_b - l_f) <= BF16_LOSS_RTOL * abs(l_f),
              f"train step 1: {impl} bf16 loss {l_b!r} vs fp32 {l_f!r} outside rtol "
              f"{BF16_LOSS_RTOL}")
        say(f"train step 1: {impl} bf16 loss {l_b!r} vs fp32 {l_f!r} "
            f"(rel {abs(l_b - l_f) / abs(l_f):.3e}, tolerance {BF16_LOSS_RTOL:g})")
    say(f"train step time on {card}: " + "; ".join(
        f"{impl} {sd} {run['step_ms']:.3f} ms, {n_real_edges / run['step_ms'] * 1e3:.0f} edges/s"
        for (impl, sd), run in runs.items()))
    launches = {k: sum(run["launches"][k] for run in runs.values()) for k in launch_counts()}
    by_impl = {impl: {k: sum(run["launches"][k] for (i, _), run in runs.items() if i == impl)
                      for k in launches} for impl, _, _ in TRAIN_RUNS}
    say(f"train: kernel launches over the phase {launches}")
    return {"launches": launches, "launches_by_impl": by_impl,
            "step_ms": {f"{impl} {sd}": run["step_ms"] for (impl, sd), run in runs.items()},
            "peak_gb": {f"{impl} {sd}": run["peak_gb"] for (impl, sd), run in runs.items()},
            "breakdown_ms": breakdown}


MGN_STEPS = 3


def mgn_train_phase(samples: list, card: str) -> dict:
    """MeshGraphNets (latent 128, 15 blocks, lr 1e-4) takes MGN_STEPS Adam
    steps on ``samples`` with node types, velocities and targets drawn from
    a seed: every loss finite, each step launching ``mgn_edge_fwd`` once a
    block and no port kernel but it and #3. Returns the phase's launches."""
    import dataclasses

    import numpy as np
    import torch

    from p_div_gnn_tpu_torch.graphs.batching import NodeFieldSample, pack_batch
    from p_div_gnn_tpu_torch.models import meshgraphnets as mgn
    from p_div_gnn_tpu_torch.train.loop import Trainer

    rng = np.random.default_rng(0)
    fields = []
    for s in samples:
        types = np.eye(mgn.NODE_TYPES)[rng.integers(0, mgn.WALL_BOUNDARY + 1, s.num_nodes)]
        velocity = rng.normal(size=(s.num_nodes, mgn.VELOCITY))
        fields.append(NodeFieldSample(
            **{f.name: getattr(s, f.name) for f in dataclasses.fields(s)},
            node_inputs=np.concatenate([velocity, types], axis=1).astype(np.float32),
            node_targets=rng.normal(size=(s.num_nodes, mgn.OUT_FEATURES)).astype(np.float32)))
    batch = pack_batch(fields, reorder="rcm").to("cuda")
    model = mgn.MeshGraphNets(stats=mgn.compute_mgn_stats(fields),
                              generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model=model, learning_rate=1e-4, objective=mgn.objective, device="cuda")
    trainer.init()
    S = model.message_passing_steps
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    reset_launch_counts()
    losses, step_ms = [], []
    for step in range(MGN_STEPS):
        before = launch_counts()
        start.record()
        aux = trainer.train_step(batch)
        stop.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(stop))
        delta = {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}
        check(delta.get("mgn_edge_fwd") == S
              and set(delta) <= {"mgn_edge_fwd", "segment_sum_csr"},
              f"train mgn step {step + 1}: kernel launches {delta}, expected {S} of "
              "mgn_edge_fwd and none but #3 besides")
        losses.append(float(aux["total"]))
        check(math.isfinite(losses[-1]), f"train mgn step {step + 1}: loss {losses[-1]}")
    launches = launch_counts()
    say(f"train mgn fp32 on {card}: losses " + " ".join(f"{v:.6f}" for v in losses)
        + ", step ms " + " ".join(f"{v:.1f}" for v in step_ms)
        + f", peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB, launches per step "
        + ", ".join(f"{k} {v // MGN_STEPS}" for k, v in launches.items() if v))
    del trainer, model, batch
    torch.cuda.empty_cache()
    return {"launches": launches}


GC_STEPS = 3


def graphcast_train_phase(card: str) -> dict:
    """GraphCast_small at the benchmark cell's size (``perfbench/configs/
    graphcast-small-fp32.json``: the 1° grid, mesh levels 2-5, latent 512,
    16 steps, AdamW with clipping) takes GC_STEPS steps on samples drawn
    from a seed through ``FixedGraphLoader``: the built graph's counts are
    the configuration's, every loss finite, the first one the reference's
    (``perfbench/reference/graphcast.py`` in fp64, its own graph) within the
    cell's ``loss1_gap`` limit, each step launching #3 3 times an
    interaction step and no other port kernel, and no edge update taking
    MeshGraphNets' kernel (``mgn.edge_fused_rows`` never counted). Returns
    the phase's launches. Before the steps, #3 sums (slots, L) rows over
    each edge set's receiver layout into its receiver set and over its
    sender view into its sender set, the two sums of the edge update's
    backward, held against the plain version at CSR_TOL."""
    import torch

    from p_div_gnn_tpu_torch.ops.scatter_csr import csr_segment_sum, csr_segment_sum_reference
    from p_div_gnn_tpu_torch.utils import profiling
    from perfbench.arch import graphcast as arch
    from perfbench.harness import train_grid
    from perfbench.harness.compare import limits

    cfg = json.loads((ROOT / "perfbench/configs/graphcast-small-fp32.json").read_text())
    traffic = json.loads((ROOT / "perfbench/traffic/train-grid-1deg.json").read_text())
    traffic["samples"] = GC_STEPS
    t0 = time.perf_counter()
    inputs = train_grid.make_inputs(cfg, traffic, 0, "cuda")
    t_setup = time.perf_counter() - t0
    counts = inputs["graph"].counts()
    check(counts == cfg["graph"], f"train graphcast: graph {counts}, configuration {cfg['graph']}")
    graph, L = inputs["graph"].to("cuda"), cfg["latent_size"]
    gen = torch.Generator(device="cuda").manual_seed(3)
    sums = []
    for name, e in graph.edges.items():
        rows = torch.randn((e.slots, L), generator=gen, device="cuda")
        n_r, n_s = graph.nodes[e.receiver_set].n_padded, graph.nodes[e.sender_set].n_padded
        held(f"segment_sum_csr {name} receivers L={L}",
             csr_segment_sum(rows, e.receivers, e.block_tile, n_r, e.tile),
             csr_segment_sum_reference(rows, e.receivers, n_r), CSR_TOL["float32"])
        held(f"segment_sum_csr {name} senders L={L}",
             csr_segment_sum(rows, e.snd_run_sorted, e.snd_block_tile, n_s, e.tile,
                             perm=e.snd_run_perm),
             csr_segment_sum_reference(rows, e.snd_run_sorted, n_s, e.snd_run_perm),
             CSR_TOL["float32"])
        sums.append(f"{name} {e.slots} slots into {n_r} / {n_s}")
    del graph, rows
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer, loader = arch.build_program(cfg, traffic, inputs, arch.draw_weights(cfg, 0, "cuda"),
                                         "cuda")
    t_setup += time.perf_counter() - t0
    per_step = 3 * (cfg["message_passing_steps"] + 2)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    reset_launch_counts()
    losses, step_ms = [], []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for step, sample in enumerate(loader):
            before = launch_counts()
            start.record()
            aux = trainer.train_step(sample)
            stop.record()
            torch.cuda.synchronize()
            step_ms.append(start.elapsed_time(stop))
            delta = {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}
            check(delta == {"segment_sum_csr": per_step},
                  f"train graphcast step {step + 1}: kernel launches {delta}, expected "
                  f"{per_step} of #3 and none besides")
            losses.append(float(aux["total"]))
            check(math.isfinite(losses[-1]), f"train graphcast step {step + 1}: loss {losses[-1]}")
    counters = profiling.recorded().counters
    check("mgn.edge_fused_rows" not in counters,
          f"train graphcast: an edge update took the L = 128 kernel: {counters}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = launch_counts()
    del trainer, loader
    torch.cuda.empty_cache()
    ref_loss = train_grid.reference_first_steps(cfg, inputs, "cuda", n=1)["losses"][0]
    gap = abs(losses[0] - ref_loss) / abs(ref_loss)
    limit = limits("train.graphcast.fp32")["loss1_gap"]
    check(gap <= limit, f"train graphcast: first loss {losses[0]} against the reference's "
          f"{ref_loss}: gap {gap:.3g} over the cell's limit {limit}")
    say(f"train graphcast fp32 on {card}: #3 held at L = {L} over " + ", ".join(sums))
    say(f"train graphcast fp32 on {card}: graph {counts}, set-up {t_setup:.1f} s, losses "
        + " ".join(f"{v:.6f}" for v in losses) + f" (reference {ref_loss:.6f}, gap {gap:.3g}), "
        + "step ms " + " ".join(f"{v:.1f}" for v in step_ms)
        + f", the steps' peak memory {peak:.2f} GB, launches per step "
        + ", ".join(f"{k} {v // GC_STEPS}" for k, v in launches.items() if v))
    torch.cuda.empty_cache()
    return {"launches": launches}


# --- the cli phase: the user's path, config -> dataset -> loader -> fit -> infer
CLI_TRAIN_MESHES, CLI_TEST_MESHES, CLI_EPOCHS = 32, 16, 3
CLI_CONFIGS = {"float32": "config_train_div_flagship.yml",
               "bfloat16": "config_train_div_flagship_bf16.yml"}
CLI_TAGS = {"Loss/MSE Train", "Loss/Loss Train", "Loss/MSE Test", "Loss/Divergence Train",
            "Loss/Divergence test value"}


def write_cli_dataset(root: Path) -> dict:
    """The train and test ``dataset.csv`` tables of plate-with-hole meshes
    drawn as ``datagen/workload.py::build_samples`` draws them, written with
    the port only: a ``.vtk`` and a sample ``.npz`` per mesh (divergence
    operator, node labels, the learnable target mean_stress · (1 + 0.2
    sin(x/20)) of the JAX package's toy dataset, tests/test_train_e2e.py)."""
    import numpy as np

    from p_div_gnn_tpu_torch.datagen.mesher import hole_plate_mesh
    from p_div_gnn_tpu_torch.datagen.opdiv import compute_op_div_matrix
    from p_div_gnn_tpu_torch.graphs.labels import compute_node_labels
    from p_div_gnn_tpu_torch.graphs.meshio import save_sample_npz, write_vtk
    from p_div_gnn_tpu_torch.utils.configio import write_csv

    rng = np.random.default_rng(0)
    csvs = {}
    mesh_id = 0
    for split, count in (("train", CLI_TRAIN_MESHES), ("test", CLI_TEST_MESHES)):
        folder = root / split
        (folder / "meshes").mkdir(parents=True)
        (folder / "fields").mkdir()
        rows = {k: [] for k in ("mesh_filename", "data_filename", "mean_stress_x",
                                "mean_stress_y", "mean_stress_xy", "hole_plate_radius")}
        for i in range(count):
            radius = float(rng.uniform(15, 30))
            mesh = hole_plate_mesh(100.0, 100.0, radius=radius, hole_center=(50.0, 50.0),
                                   hole_refinement_factor=8.0, global_mesh_refinement_size=2.5,
                                   seed=mesh_id)
            mesh_id += 1
            n = mesh.n_points
            op = compute_op_div_matrix(mesh.points[:, :2], mesh.faces)
            mean_stress = rng.normal(size=3)
            stress = mean_stress[None, :] * (1.0 + 0.2 * np.sin(mesh.points[:, :1] / 20.0))
            mesh_fn = folder / "meshes" / f"hole_plate_mesh_{i}.vtk"
            data_fn = folder / "fields" / f"hole_plate_mesh_{i}.npz"
            write_vtk(mesh_fn, mesh)
            save_sample_npz(
                data_fn, stress_field=stress.astype(np.float32),
                mean_stress=mean_stress.astype(np.float32),
                mean_strain=rng.normal(size=3).astype(np.float32),
                op_div_matrix_data=op.data.astype(np.float32),
                op_div_matrix_row_indices=op.row.astype(np.int64),
                op_div_matrix_col_indices=op.col.astype(np.int64),
                op_div_matrix_shape=np.array(op.shape),
                op_mean_stress=np.zeros((3, n), np.float32),
                node_labels=compute_node_labels(mesh),
            )
            for k, v in zip(rows, (str(mesh_fn), str(data_fn), *mean_stress, radius)):
                rows[k].append(v)
        csvs[split] = folder / "dataset.csv"
        write_csv(csvs[split], rows)
    return csvs


def cli_train(sd: str, csvs: dict, root: Path) -> dict:
    """``cli.train_main`` on a config derived from the committed flagship
    config of ``sd``: the launch counts from 0 just before and read just
    after, the trained model kept (a recording Trainer) and the run's
    checkpoints, losses and logged tags checked."""
    import json

    import torch

    from p_div_gnn_tpu_torch import cli
    from p_div_gnn_tpu_torch.train import runner
    from p_div_gnn_tpu_torch.train.checkpoint import (
        BEST_CHECKPOINT,
        LAST_CHECKPOINT,
        load_checkpoint,
        read_msgpack,
    )
    from p_div_gnn_tpu_torch.utils.configio import read_config

    cfg = read_config(ROOT / "scripts" / "configs_train" / CLI_CONFIGS[sd])
    check(cfg["latent_size"] == LATENT and cfg["message_passing_steps"] == STEPS
          and cfg["batch_size"] == 16 and cfg["scatter_impl"] == "fused3"
          and cfg.get("stream_dtype", "float32") == sd and cfg["train_all_epochs"],
          f"{CLI_CONFIGS[sd]} is no longer the flagship configuration: {cfg}")
    results = root / f"run_{sd}"
    cfg.update(dataset_train_csv=str(csvs["train"]), dataset_test_csv=str(csvs["test"]),
               results_folder=str(results), epochs=CLI_EPOCHS)
    config = root / f"train_{sd}.yml"
    config.write_text("".join(f"{k}: {v}\n" for k, v in cfg.items()))

    trained = []

    class Recording(runner.Trainer):
        def fit(self, *args, **kwargs):
            trained.append(self)
            return super().fit(*args, **kwargs)

    plain_trainer, runner.Trainer = runner.Trainer, Recording
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        cli.train_main(["--config_path", str(config)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = launch_counts()
    finally:
        runner.Trainer = plain_trainer
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    name = f"cli train fused3 {sd}"
    check(len(trained) == 1, f"{name}: {len(trained)} trainers")
    train_batches = -(-CLI_TRAIN_MESHES // cfg["batch_size"])
    test_batches = -(-CLI_TEST_MESHES // cfg["batch_size"])
    steps = CLI_EPOCHS * train_batches
    # the runner keeps the JAX package's default remat_steps=True: each
    # step's forward runs again in the backward
    fwd_per_step = STEPS * (2 if trained[0].model.remat_steps else 1)
    expect = {k: 0 for k in launches}
    expect.update(fused_edge3_fwd=fwd_per_step * steps + STEPS * CLI_EPOCHS * test_batches,
                  fused_edge3_bwd=STEPS * steps, segment_sum_csr=STEPS * steps)
    check(launches == expect, f"{name}: kernel launches {launches}, expected {expect}")

    records = [json.loads(line) for line in
               (results / "train_logs" / "metrics.jsonl").read_text().splitlines()]
    scalars = [r for r in records if "value" in r]
    check({r["tag"] for r in scalars} == CLI_TAGS,
          f"{name}: logged tags {sorted({r['tag'] for r in scalars})}")
    losses = [r["value"] for r in scalars if r["tag"] == "Loss/Loss Train"]
    test_losses = [r["value"] for r in scalars if r["tag"] == "Loss/MSE Test"]
    stamps = [r["time"] for r in scalars if r["tag"] == "Loss/MSE Train"]
    check(len(losses) == CLI_EPOCHS and all(map(math.isfinite, losses + test_losses)),
          f"{name}: epoch losses {losses}, test {test_losses}")
    check(losses[-1] < losses[0], f"{name}: epoch-{CLI_EPOCHS} train loss {losses[-1]} is not "
          f"below epoch 1's {losses[0]}")

    model = {k: v.detach().cpu() for k, v in trained[0].model.state_dict().items()}
    best_epoch = 1 + min(range(CLI_EPOCHS), key=test_losses.__getitem__)
    for ckpt, epoch in ((LAST_CHECKPOINT, CLI_EPOCHS), (BEST_CHECKPOINT, best_epoch)):
        state_dict, got_epoch, _ = load_checkpoint(results / "weights" / ckpt)
        count = int(read_msgpack((results / "weights" / ckpt).read_bytes())
                    ["optimizer_state_dict"]["0"]["count"])
        check(got_epoch == epoch and count == epoch * train_batches,
              f"{name}: {ckpt} epoch {got_epoch} Adam count {count}, expected {epoch}, "
              f"{epoch * train_batches}")
        if epoch == CLI_EPOCHS:
            bad = [k for k in model if not torch.equal(state_dict[k], model[k])]
            check(not bad, f"{name}: {ckpt} params differ from the trained model's: {bad}")
    epoch_s = [b - a for a, b in zip(stamps, stamps[1:])]
    say(f"{name}: {seconds:.1f} s for {CLI_EPOCHS} epochs of {train_batches} steps + "
        f"{test_batches} eval batch; epoch losses " + " ".join(f"{v:.6f}" for v in losses)
        + ", test " + " ".join(f"{v:.6f}" for v in test_losses)
        + f"; s per epoch after the first {' '.join(f'{s:.3f}' for s in epoch_s)}; "
        f"peak memory {peak_gb:.2f} GB; launches {launches}; checkpoints read back "
        f"(last: epoch {CLI_EPOCHS}, params bit-equal to the trained model's; best: epoch "
        f"{best_epoch})")
    return {"launches": launches, "last": results / "weights" / LAST_CHECKPOINT,
            "epoch_s": epoch_s, "seconds": seconds, "peak_gb": peak_gb, "trainer": trained[0]}


def loader_batch_kernels(batch, sd_name: str, n_ext: int | None = None,
                         name: str = "cli loader batch") -> dict:
    """Hold #1, #2 and #3 against their plain versions on a loader batch
    on the card, in ``sd_name``: its bucketed capacities end in a long run
    of padding slots, which the fused3 wrappers do not hand to their
    kernels (``ops/segment.py::live_slots``) but must still return as the
    plain versions do. Random inputs as in the kernel phases; the kernel
    phases' tolerances. Returns each kernel's max abs err. ``n_ext``: an
    edge-partitioned shard, whose senders address its ``[local ++ ghost]``
    rows: #1 gathers g_x from them and #3 sums into them."""
    import torch

    from p_div_gnn_tpu_torch.ops.fused_edge3 import (
        fused_edge_step3,
        fused_edge_step3_backward,
        fused_edge_step3_backward_reference,
        fused_edge_step3_reference,
    )
    from p_div_gnn_tpu_torch.ops.scatter_csr import csr_segment_sum, csr_segment_sum_reference

    dev = batch.receivers.device
    Np, Ep, L = batch.num_nodes_padded, batch.num_edges_padded, LATENT
    sd = getattr(torch, sd_name)
    gen = torch.Generator(device=dev).manual_seed(3)
    base = edge_step_inputs(batch, gen, n_ext=n_ext)
    args = [base[k].to(sd).contiguous() for k in base]
    aux = (batch.edge_gid, batch.edge_block_tile)
    name = f"{name} {sd_name}"
    n_rows = n_ext or Np
    got = fused_edge_step3(*args, batch.receivers, aux, batch.n_graphs, batch.tile)
    want = fused_edge_step3_reference(*args, batch.receivers, batch.edge_gid, batch.n_graphs)
    fwd = max(held(f"{name} fused_edge3_fwd {k}", a, b, KERNEL_TOL[sd_name][k])[0]
              for k, a, b in zip(("z_upd", "R", "M"), got, want))
    z_upd = want[0]
    del got, want
    dz, dr, dm = (torch.randn(shape, generator=gen, device=dev)
                  for shape in ((Ep, L), (Np, L), (8, L)))
    dz = dz.to(sd)
    got = fused_edge_step3_backward(*args, batch.receivers, aux, batch.n_graphs, batch.tile,
                                    z_upd, dz, dr, dm)
    want = fused_edge_step3_backward_reference(*args, batch.receivers, batch.edge_gid,
                                               batch.n_graphs, z_upd, dz, dr, dm)
    bwd = max(held(f"{name} fused_edge3_bwd {k}", a, b, BWD_TOL[sd_name])[0]
              for k, a, b in zip(("dx", "dg", "de", "dWu", "dWv", "dWe", "db0", "dW2", "db2"),
                                 got, want))
    del got, want
    rows = torch.randn((Ep, L), generator=gen, device=dev).to(sd)
    csr = held(f"{name} segment_sum_csr",
               csr_segment_sum(rows, batch.snd_run_sorted, batch.snd_block_tile, n_rows,
                               batch.tile, perm=batch.snd_run_perm),
               csr_segment_sum_reference(rows, batch.snd_run_sorted, n_rows, batch.snd_run_perm),
               CSR_TOL[sd_name])[0]
    torch.cuda.empty_cache()
    return {"fused_edge3_fwd": fwd, "fused_edge3_bwd": bwd, "segment_sum_csr": csr}


def cli_step_time(samples: list, trainer, sd: str) -> dict:
    """On the loader's bucketed batches of the train set (as the CLI run
    caches them): #1-#3 held against their plain versions on the first
    batch, then the median step (CUDA events, steps 2-4) of the CLI run's
    own trainer (remat on), against the same meshes packed as ``bench.py``
    packs them (no capacities)."""
    import torch

    from p_div_gnn_tpu_torch.datagen.workload import pack_workload
    from p_div_gnn_tpu_torch.train.data import GraphLoader
    from p_div_gnn_tpu_torch.train.runner import SEED

    loader = GraphLoader(samples, 16, shuffle=True, seed=SEED, cache_groups=True,
                         device="cuda")
    batches = list(loader)
    errs = loader_batch_kernels(batches[0], sd)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    step_ms = []
    for i in range(4):
        start.record()
        trainer.train_step(batches[i % len(batches)])
        stop.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(stop))
    # the first 16 meshes packed as the loader packs them and as bench.py does
    group, bench = loader._pack(range(16)), pack_workload(samples[:16])[0]
    real_nodes = int(group.graph_node_count.sum())
    real_edges = int((group.edge_gid < group.n_graphs).sum())
    check(real_edges == int((bench.edge_gid < bench.n_graphs).sum()),
          "cli: the loader's and bench.py's packing of the same meshes differ in edges")
    return {"step_ms": statistics.median(step_ms[1:]), "edges": real_edges,
            "np": group.num_nodes_padded, "ep": group.num_edges_padded, "nodes": real_nodes,
            "bench_np": bench.num_nodes_padded, "bench_ep": bench.num_edges_padded,
            "errs": errs, "remat": trainer.model.remat_steps}


def cli_phase(card: str) -> dict:
    """The user's path on the card: write an on-disk dataset with the port,
    train fused3 in fp32 and bf16 through ``cli.train_main`` (configs from
    the committed flagship ones, cut to 3 epochs of 32 meshes), then
    ``cli.infer_main`` from the committed inference config on the fp32
    run's last checkpoint, held against ``Predictor`` on the plain xla
    path; #1-#3 held against their plain versions on a loader batch."""
    import json
    import shutil
    import tempfile

    import numpy as np
    import torch

    from p_div_gnn_tpu_torch import cli
    from p_div_gnn_tpu_torch.graphs.dataset import MeshStressFieldDataset
    from p_div_gnn_tpu_torch.inference import Predictor
    from p_div_gnn_tpu_torch.utils.configio import read_config, read_csv

    (ROOT / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="cli_phase_", dir=ROOT / "build"))
    try:
        t0 = time.perf_counter()
        csvs = write_cli_dataset(root)
        t1 = time.perf_counter()
        train_ds = MeshStressFieldDataset(read_csv(csvs["train"]))
        test_ds = MeshStressFieldDataset(read_csv(csvs["test"]))
        t2 = time.perf_counter()
        say(f"cli dataset: {CLI_TRAIN_MESHES} train + {CLI_TEST_MESHES} test meshes written "
            f"in {t1 - t0:.1f} s, loaded in {t2 - t1:.1f} s "
            f"({sum(s.num_nodes for s in train_ds.samples)} train nodes)")
        runs = {sd: cli_train(sd, csvs, root) for sd in CLI_CONFIGS}

        cfg = read_config(ROOT / "scripts" / "configs_inference" / "config_inference_div.yml")
        cfg.update(dataset_csv=str(csvs["test"]), results_folder=str(root / "infer"),
                   model_weights_path=str(runs["float32"]["last"]), scatter_impl="fused3")
        config = root / "infer.yml"
        config.write_text("".join(f"{k}: {v}\n" for k, v in cfg.items()))
        reset_launch_counts()
        t0 = time.perf_counter()
        cli.infer_main(["--config_path", str(config)])
        infer_s = time.perf_counter() - t0
        launches = launch_counts()
        batches = -(-CLI_TEST_MESHES // cfg["batch_size"])
        expect = {k: 0 for k in launches}
        expect["fused_edge3_fwd"] = STEPS * batches
        check(launches == expect, f"cli infer: kernel launches {launches}, expected {expect}")

        table = read_csv(root / "infer" / "dataset.csv")
        norm = json.loads((root / "infer" / "normalize_params.json").read_text())
        predictor = Predictor(runs["float32"]["last"], cfg["latent_size"],
                              cfg["message_passing_steps"], scatter_impl="xla",
                              device="cuda")
        want = predictor.predict(test_ds.samples)
        worst = ratio = 0.0
        for path, ref, s in zip(table["data_filename"], want, test_ds.samples, strict=True):
            got = np.load(path)["stress_field"]
            check(got.shape == (s.num_nodes, 3) and bool(np.isfinite(got).all()),
                  f"cli infer: field {path} shape {got.shape} or non-finite")
            z_got = (got - norm["mean_local_stress"]) / norm["std_local_stress"]
            z_ref = (ref - norm["mean_local_stress"]) / norm["std_local_stress"]
            err = np.abs(z_got - z_ref)
            share = float((err / (SERVE_ATOL + SERVE_RTOL * np.abs(z_ref))).max())
            worst, ratio = max(worst, float(err.max())), max(ratio, share)
        check(ratio <= 1.0, f"cli infer vs Predictor xla: max abs err {worst:.3e} "
              f"(standardized) outside rtol={SERVE_RTOL} atol={SERVE_ATOL} "
              f"({ratio:.2f} of the allowance)")
        say(f"cli infer fused3: {CLI_TEST_MESHES} meshes in {infer_s:.1f} s, launches "
            f"{launches}; vs Predictor xla max abs err (standardized) {worst:.3e}, "
            f"{ratio:.2f} of the allowance")

        steps = {sd: cli_step_time(train_ds.samples, runs[sd]["trainer"], sd)
                 for sd in CLI_CONFIGS}
        for sd, v in steps.items():
            say(f"cli loader batch {sd}: #1-#3 vs plain max abs err "
                + " ".join(f"{k}={e:.3e}" for k, e in v["errs"].items()))
        s = steps["float32"]
        say(f"cli on {card}: loader batch of 16 meshes Np={s['np']} Ep={s['ep']} "
            f"({s['nodes']} nodes, {s['edges']} edges: padding {1 - s['nodes'] / s['np']:.3f} "
            f"of node slots, {1 - s['edges'] / s['ep']:.3f} of edge slots) against bench.py's "
            f"unbucketed Np={s['bench_np']} Ep={s['bench_ep']}; median train step of the "
            f"CLI run's trainer (remat {'on' if s['remat'] else 'off'}) "
            + "; ".join(f"{sd} {v['step_ms']:.3f} ms, {v['edges'] / v['step_ms'] * 1e3:.0f} "
                        f"edges/s" for sd, v in steps.items())
            + "; s per epoch " + "; ".join(
                f"{sd} {' '.join(f'{x:.3f}' for x in r['epoch_s'])}" for sd, r in runs.items())
            + "; peak memory " + ", ".join(f"{sd} {r['peak_gb']:.2f} GB"
                                          for sd, r in runs.items()))
        total = {k: sum(r["launches"][k] for r in runs.values()) + launches[k]
                 for k in launches}
        torch.cuda.empty_cache()
        return {"launches": total}
    finally:
        shutil.rmtree(root, ignore_errors=True)


# --- the parallel phase: data-parallel and edge-partitioned training over ranks
PAR_RANKS = 2
HALO_MODES = ("a2a", "all_gather")
PAR_DP_STEPS, PAR_BF16_STEPS = 5, 2
# tests/test_dp.py's tolerances (step-1 loss rtol 2e-4, parameters after
# Adam rtol 5e-3 / atol 2e-5) and tests/test_partition.py's (total and nmse
# rtol 5e-4, divergence 5e-3, parameters rtol 5e-3 / atol 5e-5); raw
# gradients at GRAD_RTOL, bf16 losses at BF16_LOSS_RTOL of fp32's
DP_LOSS_RTOL, PART_LOSS_RTOL, PART_DIV_RTOL = 2e-4, 5e-4, 5e-3
PARAM_RTOL, DP_PARAM_ATOL, PART_PARAM_ATOL = 5e-3, 2e-5, 5e-5
# the most entries of one step whose gradient sign is inside fp32 noise and
# whose Adam step went the other way (the most seen on the card: 2)
FREED_MAX = 2
SCALING_ITERS = 3
# the committed checkpoint's partitioned forward also at this many ranks
# where the machine has as many cards
WIDE_RANKS = 4


def parallel_backend() -> str:
    """NCCL with a card per rank; with fewer cards gloo, every rank's model,
    batch and kernels on card 0 (NCCL refuses two ranks on one card), its
    collectives staged through host memory."""
    import torch

    return "nccl" if torch.cuda.device_count() >= PAR_RANKS else "gloo"


def reference_step(impl: str, batch) -> dict:
    """One single-process fp32 train step from the seeded init on the whole
    batch: loss terms, gradients and parameters after Adam, on the host."""
    trainer = make_trainer(impl, "float32", batch.receivers.device)
    aux, grads = trainer.loss_and_grads(batch)
    grads = {n: g.detach().cpu() for n, g in grads.items()}
    trainer.optimizer.step()
    params = {n: p.detach().cpu() for n, p in trainer.model.named_parameters()}
    return {"aux": {k: float(v) for k, v in aux.items()}, "grads": grads, "params": params}


def parallel_rank(rank: int, world: int, group, job: dict) -> dict:
    """One rank of the parallel phase (spawned). Each training step's kernel
    launches are counted from 0 and must be its path's; returns what the
    parent holds against the single-process steps."""
    import torch
    import torch.distributed as dist

    from p_div_gnn_tpu_torch.graphs.container import NormStats
    from p_div_gnn_tpu_torch.inference import Predictor
    from p_div_gnn_tpu_torch.models.epd import Halo
    from p_div_gnn_tpu_torch.parallel.dp import shard_of
    from p_div_gnn_tpu_torch.parallel.partition import (
        make_partitioned_forward,
        make_partitioned_train_step,
    )

    dev = torch.device("cuda", rank if dist.get_backend(group) == "nccl" else 0)
    torch.cuda.set_device(dev)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    total = {k: 0 for k in launch_counts()}

    def counted(fn, impl: str, name: str, per_step: dict | None = None):
        """fn() with its launches held to one step of ``impl`` (or
        ``per_step``); returns its result and its device ms."""
        expect = {k: (per_step or step_launches(impl)).get(k, 0) for k in total}
        reset_launch_counts()
        start.record()
        out = fn()
        stop.record()
        torch.cuda.synchronize()
        got = launch_counts()
        check(got == expect, f"parallel rank {rank} {name}: kernel launches {got}, "
              f"expected {expect}")
        for k, v in got.items():
            total[k] += v
        return out, start.elapsed_time(stop)

    def host(model) -> tuple[dict, dict]:
        grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        return grads, {n: p.detach().cpu() for n, p in model.named_parameters()}

    def loss_terms(aux: dict) -> dict:
        out = {k: float(v) for k, v in aux.items()}
        check(all(math.isfinite(v) for v in out.values()),
              f"parallel rank {rank}: non-finite loss {out}")
        return out

    out = {"part": {}}
    # #1-#3 against their plain versions on this shard's extended layout
    # (before the counted runs)
    stacked, send_idx = job["plans"]["a2a"]
    local = shard_of(stacked, rank).to(dev)
    n_ext = local.num_nodes_padded + send_idx.shape[0] * send_idx.shape[-1]
    out["kernel_errs"] = {sd: loader_batch_kernels(local, sd, n_ext, f"parallel rank {rank}")
                          for sd in ("float32", "bfloat16")}
    torch.cuda.reset_peak_memory_stats(dev)

    # (a) data parallel: this rank's 8 meshes, Trainer(group=)
    batch = shard_of(job["dp"], rank).to(dev)
    trainer = make_trainer("fused3", "float32", dev, group=group)
    losses, ms = [], []
    for step in range(PAR_DP_STEPS):
        aux, t = counted(lambda: trainer.train_step(batch), "fused3", f"dp step {step + 1}")
        losses.append(loss_terms(aux))
        ms.append(t)
        if step == 0:
            grads, params = host(trainer.model)
    out["dp"] = {"losses": losses, "ms": ms, "grads": grads, "params": params}
    trainer = make_trainer("fused3", "bfloat16", dev, group=group)
    runs = [counted(lambda: trainer.train_step(batch), "fused3", f"dp bf16 step {i + 1}")
            for i in range(PAR_BF16_STEPS)]
    out["dp_bf16"] = {"losses": [loss_terms(a) for a, _ in runs], "ms": [t for _, t in runs]}
    del trainer, batch

    # (b, c) edge partitioning of the whole batch
    stats = NormStats.ones()
    served = Predictor(CHECKPOINT, LATENT, STEPS, scatter_impl="fused3", device=dev)
    for mode in HALO_MODES:
        stacked, send_idx = job["plans"][mode]
        local = shard_of(stacked, rank).to(dev)
        halo = Halo(torch.as_tensor(send_idx[rank]).to(dev), group)
        fwd = make_partitioned_forward(served.model, served.stats, group, scale_output=False)
        fwd(local, halo)  # uncounted: NCCL sets up its peer connections at first use
        pred, fwd_ms = counted(lambda: fwd(local, halo), "fused3", f"{mode} forward",
                               {k: STEPS * v for k, v in SERVE_LAUNCHES["fused3"].items()})
        res = {"forward": pred.cpu(), "forward_ms": fwd_ms}
        for impl, sd in (("fused3", "float32"), ("fused3", "bfloat16"), ("fused", "float32")):
            if impl == "fused" and mode != "a2a":
                continue
            trainer = make_trainer(impl, sd, dev)
            step = make_partitioned_train_step(trainer.model, stats, trainer.optimizer, group,
                                               DIV_PENALTY, optimize_divergence=True)
            aux, t = counted(lambda: step(local, halo), impl, f"{mode} {impl} {sd} step")
            grads, params = host(trainer.model)
            res[(impl, sd)] = {"aux": loss_terms(aux), "ms": t, "grads": grads,
                               "params": params}
            del trainer, step
        out["part"][mode] = res
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    out["launches"] = total
    out["staged"] = str(dist.get_backend(group)) == "gloo"
    return out


def served_forward(train_batch):
    """The committed checkpoint's single-process fused3 forward of
    ``train_batch`` (standardized, on the host)."""
    import torch

    from p_div_gnn_tpu_torch.inference import Predictor

    served = Predictor(CHECKPOINT, LATENT, STEPS, scatter_impl="fused3", device="cuda")
    with torch.no_grad():
        out = served.model(train_batch, served.stats, scale_output=False).cpu().numpy()
    del served
    torch.cuda.empty_cache()
    return out


def wide_forward_phase(host_train, train_batch, want_fwd) -> tuple[list, dict]:
    """Where the machine has WIDE_RANKS cards: the committed checkpoint's
    partitioned forward at D = WIDE_RANKS (NCCL, both halo modes) against
    its single-process forward ``want_fwd``, with its share of the serve
    allowance printed. Returns the failed checks and the ranks' launches."""
    import torch

    from p_div_gnn_tpu_torch.parallel.launch import run_ranks
    from p_div_gnn_tpu_torch.parallel.partition import partition_batch

    launches = {k: 0 for k in launch_counts()}
    if torch.cuda.device_count() < WIDE_RANKS:
        say(f"parallel: {torch.cuda.device_count()} card(s): the D={WIDE_RANKS} partitioned "
            "forward is not run")
        return [], launches
    plans = {mode: partition_batch(host_train, WIDE_RANKS, halo_mode=mode)
             for mode in HALO_MODES}
    try:
        ranks = run_ranks(wide_forward_rank, WIDE_RANKS, plans, backend="nccl")
    except Exception as exc:  # a rank's failure, with its traceback
        raise SmokeFailure(f"parallel D={WIDE_RANKS} ranks failed: {exc}") from exc
    failed = []
    for mode in HALO_MODES:
        stacked, send_idx = plans[mode]
        err, share = forward_share(stacked, [res[mode] for res in ranks], host_train,
                                   train_batch, want_fwd)
        say(f"parallel D={WIDE_RANKS} {mode} checkpoint forward vs single fused3: max abs err "
            f"{err:.3e} (standardized), {share:.2f} of the serve allowance; per rank "
            f"Nl={stacked.pos.shape[1]} El={stacked.senders.shape[1]} "
            f"D*Hp={WIDE_RANKS * send_idx.shape[-1]}")
        if share > 1.0:
            failed.append(f"D={WIDE_RANKS} {mode} forward vs single: max abs err {err:.3e}, "
                          f"{share:.2f} of the serve allowance")
    for res in ranks:
        for k, v in res["launches"].items():
            launches[k] += v
    return failed, launches


def wide_forward_rank(rank: int, world: int, group, plans: dict) -> dict:
    """One rank of the committed checkpoint's partitioned forward at
    D = ``world`` (spawned; a card per rank), in both halo modes; each
    counted forward must launch #1 STEPS times and nothing else."""
    import torch

    from p_div_gnn_tpu_torch.inference import Predictor
    from p_div_gnn_tpu_torch.models.epd import Halo
    from p_div_gnn_tpu_torch.parallel.dp import shard_of
    from p_div_gnn_tpu_torch.parallel.partition import make_partitioned_forward

    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    served = Predictor(CHECKPOINT, LATENT, STEPS, scatter_impl="fused3", device=dev)
    out = {"launches": {k: 0 for k in launch_counts()}}
    expect = {k: STEPS * SERVE_LAUNCHES["fused3"].get(k, 0) for k in out["launches"]}
    for mode, (stacked, send_idx) in plans.items():
        local = shard_of(stacked, rank).to(dev)
        halo = Halo(torch.as_tensor(send_idx[rank]).to(dev), group)
        fwd = make_partitioned_forward(served.model, served.stats, group, scale_output=False)
        fwd(local, halo)  # uncounted: NCCL sets up its peer connections at first use
        reset_launch_counts()
        pred = fwd(local, halo)
        torch.cuda.synchronize()
        got = launch_counts()
        check(got == expect, f"parallel D={world} rank {rank} {mode} forward: kernel "
              f"launches {got}, expected {expect}")
        for k, v in got.items():
            out["launches"][k] += v
        out[mode] = pred.cpu()
    return out


def forward_share(stacked, forwards: list, host_train, train_batch, want_fwd) -> tuple:
    """The partitioned forward (each rank's rows of ``forwards``, laid out
    by the plan ``stacked``) against the single-process forward
    ``want_fwd``: (max abs err, share of the serve allowance) over the real
    nodes, standardized."""
    import numpy as np

    Np = train_batch.num_nodes_padded
    per = stacked.pos.shape[1] - train_batch.tile
    got_fwd = np.zeros_like(want_fwd)
    for r, rows in enumerate(forwards):
        lo, hi = r * per, min((r + 1) * per, Np)
        if hi > lo:
            got_fwd[lo:hi] = rows.numpy()[:hi - lo]
    real = host_train.node_gid < host_train.n_graphs
    err = np.abs(got_fwd[real] - want_fwd[real])
    share = float((err / (SERVE_ATOL + SERVE_RTOL * np.abs(want_fwd[real]))).max())
    return float(err.max()), share


def rel_norms(got: dict, want: dict) -> dict:
    import torch

    return {n: float(torch.linalg.vector_norm(got[n].double() - w.double())
                     / torch.linalg.vector_norm(w.double()).clamp_min(1e-300))
            for n, w in want.items()}


def hold_step(name: str, got: dict, want: dict, loss_rtol: float, div_rtol: float,
              param_atol: float) -> list[str]:
    """A parallel train step against the single-process one: loss terms,
    raw gradients (averaged over the ranks), parameters after Adam. Prints
    the numbers and returns the checks it fails.

    Adam's first step moves every entry by lr·g / (|g| + eps) ≈ lr·sign(g).
    Where an entry's single-process gradient is smaller than the two
    gradients' difference (both inside GRAD_RTOL), its sign is not fixed
    by the fp32 gradient: those entries are held to one Adam step either
    way (|Δp| ≤ 2·lr + the tolerance), every other entry to rtol / atol.
    The freed entries that did move the other way, counted over all the
    parameters, must be at most FREED_MAX: a fault in the parallel update
    cannot hide among them."""
    rel = rel_norms(got["grads"], want["grads"])
    worst = max(rel, key=rel.get)
    outside, loose = {}, {}
    for n, w in want["params"].items():
        g = want["grads"][n]
        free = g.abs() <= (got["grads"][n] - g).abs()
        tol = param_atol + PARAM_RTOL * w.abs()
        dp = (got["params"][n] - w).abs()
        off = (dp > tol) & ~free | (dp > tol + 2 * LEARNING_RATE) & free
        if bool(off.any()):
            outside[n] = int(off.sum())
        if bool((free & (dp > tol)).any()):
            loose[n] = int((free & (dp > tol)).sum())
    a, b = got["aux"]["total"], want["aux"]["total"]
    freed = sum(loose.values())
    say(f"parallel {name}: loss {a!r} vs single {b!r} (rel {abs(a - b) / abs(b):.3e}), "
        f"gradients max rel {rel[worst]:.3e} ({worst}), parameters after Adam outside rtol "
        f"{PARAM_RTOL} / atol {param_atol}: {outside or 'none'}; entries whose gradient is "
        f"inside the two gradients' difference and moved the other way: {freed} (at most "
        f"{FREED_MAX}) {loose or ''}")
    failed = [f"{name}: {k} {got['aux'][k]!r} vs single {want['aux'][k]!r} outside rtol {rtol}"
              for k, rtol in (("total", loss_rtol), ("nmse", loss_rtol),
                              ("divergence", div_rtol))
              if abs(got["aux"][k] - want["aux"][k]) > rtol * abs(want["aux"][k])]
    if rel[worst] > GRAD_RTOL:
        failed.append(f"{name}: gradient of {worst} vs single {rel[worst]:.3e} > {GRAD_RTOL:g}")
    if outside:
        failed.append(f"{name}: parameters after Adam outside rtol {PARAM_RTOL} / atol "
                      f"{param_atol}: {outside}")
    if freed > FREED_MAX:
        failed.append(f"{name}: {freed} entries inside the gradients' fp32 noise moved the "
                      f"other way after Adam, more than {FREED_MAX}: {loose}")
    return failed


def parallel_phase(samples: list, host_train, train_batch, card: str) -> dict:
    """Data-parallel and edge-partitioned fused3 (and one fused) training at
    full width over PAR_RANKS spawned ranks, each held against the
    single-process step on the whole batch (``train_batch``, on the card, of
    the host batch ``host_train``); the committed checkpoint's partitioned
    forward against its single-process forward (also at D = WIDE_RANKS
    where the machine has as many cards); the weak-scaling rows at the rank
    counts the cards allow."""
    import torch

    from p_div_gnn_tpu_torch.graphs.batching import pack_batch
    from p_div_gnn_tpu_torch.parallel.dp import pack_sharded_batch, shard_assignment
    from p_div_gnn_tpu_torch.parallel.launch import run_ranks
    from p_div_gnn_tpu_torch.parallel.partition import partition_batch
    from p_div_gnn_tpu_torch.parallel.scaling import measure_dp_scaling

    t_start = time.perf_counter()
    backend = parallel_backend()
    say(f"parallel: {PAR_RANKS} ranks over {backend}, {torch.cuda.device_count()} card(s)"
        + ("; every rank on card 0, collectives staged through host memory (gloo): no "
           "number of this phase is a scaling or collective time" if backend == "gloo" else ""))
    refs = {impl: reference_step(impl, train_batch) for impl in ("fused3", "fused")}
    # the data-parallel step's reference: the same meshes packed whole in the
    # order the shards hold them (RCM would reorder every graph's nodes)
    gps = len(samples) // PAR_RANKS
    order = [i for idx in shard_assignment(samples, PAR_RANKS, gps) for i in idx]
    refs["dp"] = reference_step("fused3", pack_batch(
        [samples[i] for i in order], n_graphs=len(samples)).to("cuda"))
    want_fwd = served_forward(train_batch)

    t0 = time.perf_counter()
    dp = pack_sharded_batch(samples, PAR_RANKS, gps)
    plans = {mode: partition_batch(host_train, PAR_RANKS, halo_mode=mode)
             for mode in HALO_MODES}
    plan_s = time.perf_counter() - t0
    for mode, (stacked, send_idx) in plans.items():
        rows = PAR_RANKS * send_idx.shape[-1]
        say(f"parallel plan {mode}: per rank Nl={stacked.pos.shape[1]} "
            f"El={stacked.senders.shape[1]} Ep2={stacked.snd_perm.shape[1]} D*Hp={rows} "
            f"(real nodes {(stacked.node_gid < stacked.n_graphs).sum(1).tolist()}, real edges "
            f"{(stacked.edge_gid < stacked.n_graphs).sum(1).tolist()}); halo bytes per fp32 "
            f"step {halo_bytes(rows, 4)} received per rank ({halo_bytes(rows, 2)} in bf16)")
    say(f"parallel: DP shards Np={dp.pos.shape[1]} Ep={dp.senders.shape[1]}; planned in "
        f"{plan_s:.2f} s")
    try:
        ranks = run_ranks(parallel_rank, PAR_RANKS, {"dp": dp, "plans": plans},
                          backend=backend)
    except Exception as exc:  # a rank's failure, with its traceback
        raise SmokeFailure(f"parallel ranks failed: {exc}") from exc

    for r, res in enumerate(ranks):
        errs = res["kernel_errs"]
        say(f"parallel rank {r}: #1-#3 vs plain on the extended layout, max abs err "
            + "; ".join(f"{sd} " + " ".join(f"{k}={e:.3e}" for k, e in v.items())
                        for sd, v in errs.items()))
    # (a) data parallel against the single-process step on all 16 meshes;
    # every check's numbers are printed before the phase fails on any
    failed = []
    for r, res in enumerate(ranks):
        step1 = dict(res["dp"], aux=res["dp"]["losses"][0])
        failed += hold_step(f"dp fused3 fp32 rank {r}", step1, refs["dp"], DP_LOSS_RTOL,
                            PART_DIV_RTOL, DP_PARAM_ATOL)
        rcm = rel_norms(step1["grads"], refs["fused3"]["grads"])
        say(f"parallel dp rank {r}: gradients vs the single step on the RCM-ordered batch: "
            f"max rel {max(rcm.values()):.3e}")
        losses = [x["total"] for x in res["dp"]["losses"]]
        if not losses[-1] < losses[0]:
            failed.append(f"dp rank {r}: loss {losses} does not fall")
        l16, l32 = res["dp_bf16"]["losses"][0]["total"], losses[0]
        if abs(l16 - l32) > BF16_LOSS_RTOL * abs(l32):
            failed.append(f"dp rank {r}: bf16 step-1 loss {l16!r} vs fp32 {l32!r}")
        say(f"parallel dp rank {r}: fp32 losses " + " ".join(f"{v:.6f}" for v in losses)
            + ", step ms " + " ".join(f"{v:.3f}" for v in res["dp"]["ms"])
            + f"; bf16 step-1 loss {l16:.6f} (rel {abs(l16 - l32) / abs(l32):.3e}), step ms "
            + " ".join(f"{v:.3f}" for v in res["dp_bf16"]["ms"]))
    # (b, c) edge partitioning against the single-process step and forward
    ref = refs["fused3"]
    for mode in HALO_MODES:
        err, share = forward_share(plans[mode][0], [res["part"][mode]["forward"] for res in ranks],
                                   host_train, train_batch, want_fwd)
        if share > 1.0:
            failed.append(f"{mode} forward vs single: max abs err {err:.3e} "
                          f"(standardized), {share:.2f} of the serve allowance")
        say(f"parallel {mode} checkpoint forward vs single fused3: max abs err "
            f"{err:.3e} (standardized), {share:.2f} of the allowance; forward ms "
            + " ".join(f"{res['part'][mode]['forward_ms']:.3f}" for res in ranks))
        for r, res in enumerate(ranks):
            part = res["part"][mode]
            failed += hold_step(f"{mode} fused3 fp32 rank {r}", part[("fused3", "float32")],
                                ref, PART_LOSS_RTOL, PART_DIV_RTOL, PART_PARAM_ATOL)
            l16 = part[("fused3", "bfloat16")]["aux"]["total"]
            l32 = part[("fused3", "float32")]["aux"]["total"]
            if abs(l16 - l32) > BF16_LOSS_RTOL * abs(l32):
                failed.append(f"{mode} rank {r}: bf16 loss {l16!r} vs fp32 {l32!r}")
            say(f"parallel {mode} rank {r}: step ms fused3 fp32 "
                f"{part[('fused3', 'float32')]['ms']:.3f}, bf16 "
                f"{part[('fused3', 'bfloat16')]['ms']:.3f} (loss {l16:.6f}, rel "
                f"{abs(l16 - l32) / abs(l32):.3e} from fp32)"
                + (f", fused fp32 {part[('fused', 'float32')]['ms']:.3f}"
                   if mode == "a2a" else ""))
            if mode == "a2a":
                failed += hold_step(f"{mode} fused fp32 rank {r}", part[("fused", "float32")],
                                    refs["fused"], PART_LOSS_RTOL, PART_DIV_RTOL,
                                    PART_PARAM_ATOL)
    say("parallel: peak memory per rank " + ", ".join(f"{res['peak_gb']:.2f} GB"
                                                      for res in ranks))
    launches = {k: sum(res["launches"][k] for res in ranks) for k in ranks[0]["launches"]}
    wide_failed, wide_launches = wide_forward_phase(host_train, train_batch, want_fwd)
    failed += wide_failed
    for k, v in wide_launches.items():
        launches[k] += v
    say(f"parallel: kernel launches over the ranks' counted runs {launches}")
    check(not failed, "parallel: " + "; ".join(failed))

    t0 = time.perf_counter()
    rows = measure_dp_scaling(samples[:len(samples) // PAR_RANKS], iters=SCALING_ITERS)
    for row in rows:
        say(f"parallel scaling on {card}: devices={row['devices']} step "
            f"{row['step_s'] * 1e3:.3f} ms, {row['edges_per_s']:.0f} edges/s, efficiency "
            f"{row['efficiency']:.3f} (measure_dp_scaling, xla, remat on, "
            f"{len(samples) // PAR_RANKS} meshes per card; {time.perf_counter() - t0:.1f} s)")
    say(f"parallel phase: {time.perf_counter() - t_start:.1f} s")
    torch.cuda.empty_cache()
    return {"launches": launches}


# --- the tools phase: generate -> infer -> compare, the benchmark, .pth
# the datasets the phase generates (``generate`` command arguments; every
# run with --max_workers TOOLS_WORKERS)
TOOLS_GENERATE = {
    "elastic": dict(n_samples=40, test_size=0.8, seed=2024),
    "hyperelastic": dict(hyperelastic=True, n_samples=10, test_size=0.8, seed=2024),
    "neumann": dict(bc="neumann", n_samples=4, seed=2024),
    "quad": dict(element="quad", n_samples=4, seed=2024),
}
TOOLS_WORKERS = 8
# (committed checkpoint, its committed inference config, the dataset it
# serves); each is served through ``cli.infer_main`` with fused3
TOOLS_MODELS = (
    ("elast_200e_div", "config_inference_div.yml", "elastic"),
    ("elast_200e_no_div", "config_inference_no_div.yml", "elastic"),
    ("elast_200e_no_periodic", "config_inference_no_periodic.yml", "elastic"),
    ("elast_200e_div_bf16", "config_inference_div_bf16.yml", "elastic"),
    ("hyperelast_200e_div", "config_inference_div_hyperelast.yml", "hyperelastic"),
    ("hyperelast_200e_no_div", "config_inference_no_div_hyperelast.yml", "hyperelastic"),
)
TOOLS_COMPARE = ("elastic", "hyperelastic")
# the headline table's figures: the means of compare's metric columns
COMPARE_COLUMNS = {"nmse_std": "nmse_standardized", "r2": "r2",
                   "div_model_std": "div_model_standardized",
                   "div_fem_std": "div_fem_standardized"}
# the JAX package's figures on the same generated sets (JAX generate -> JAX
# infer on xla -> JAX compare, on the CPU), and each test set's size:
# printed by scripts/port_compare_reference.py
COMPARE_REFERENCE = {
    "elastic": {
        "elast_200e_div": {
            "nmse_std": 0.012463762389277067, "r2": 0.990163707132131,
            "div_model_std": 0.0001691903702308805, "div_fem_std": 0.00031737992478459586},
        "elast_200e_no_div": {
            "nmse_std": 0.009838295688137322, "r2": 0.9919592044112756,
            "div_model_std": 0.0003247833596085077, "div_fem_std": 0.00031737992478459586},
        "elast_200e_no_periodic": {
            "nmse_std": 0.04771854344567478, "r2": 0.955754444092814,
            "div_model_std": 0.00033249669968610587, "div_fem_std": 0.00031737992478459586},
        "elast_200e_div_bf16": {
            "nmse_std": 0.00940950751524359, "r2": 0.9923056658189997,
            "div_model_std": 0.0001905938982250523, "div_fem_std": 0.00031737992478459586},
        "test_set": {"meshes": 32, "nodes": 12134},
    },
    "hyperelastic": {
        "hyperelast_200e_div": {
            "nmse_std": 0.015147765926600946, "r2": 0.9870520840628214,
            "div_model_std": 0.0004104973399014115, "div_fem_std": 0.0010000333601310276},
        "hyperelast_200e_no_div": {
            "nmse_std": 0.013667001182913995, "r2": 0.9872822469575668,
            "div_model_std": 0.0010631319318951797, "div_fem_std": 0.0010000333601310276},
        "test_set": {"meshes": 8, "nodes": 3224},
    },
}
# the port's figures against them: Div(FEM) comes from the generated data
# alone; the others from the model's fp32 fields on the card
COMPARE_RTOL = {"nmse_std": 1e-3, "r2": 1e-3, "div_model_std": 1e-3, "div_fem_std": 1e-6}
BENCH_STEPS, BENCH_MEAN_STEPS = 5, 5
# the mesher's node counts at hole refinement factors 1 and 100
# (docs/evidence/benchmark_data_elast.csv lists the same counts)
BENCH_NODES = {1.0: 303, 100.0: 11436}
BF16_SERVE_TOL = 3e-2  # the JAX package's bf16 tolerance, rtol = atol


def generate_flags(kw: dict) -> list[str]:
    """The ``generate`` command's arguments for keyword arguments of
    ``datagen/generate.py::main``."""
    out = []
    for k, v in kw.items():
        out += [f"--{k}"] if v is True else [f"--{k}", str(v)]
    return out


def checkpoint_of(cfg: dict, name: str) -> Path:
    """The committed checkpoint file of ``name`` that its inference config
    names (``model_weights.ckpt`` or ``last_epoch_model_weights.ckpt``)."""
    return ROOT / "checkpoints" / name / Path(cfg["model_weights_path"]).name


def native_check(meshes: list) -> float:
    """The native graph library must be built and loaded, and give the
    numpy paths' edge index, labels and periodic pairs on ``meshes``;
    returns its g++ seconds in this process."""
    import numpy as np

    from p_div_gnn_tpu_torch.graphs import native
    from p_div_gnn_tpu_torch.graphs.build import faces_to_edge_index
    from p_div_gnn_tpu_torch.graphs.labels import compute_node_labels
    from p_div_gnn_tpu_torch.graphs.periodic import periodic_boundary_pairs

    check(native.available(), f"tools: the native graph library is unavailable: "
          f"{native.build_error}")
    fast = [(native.faces_to_edge_index(m.faces, m.n_points),
             native.compute_node_labels(m.faces, m.points[:, :2]),
             native.periodic_pairs(m.points[:, :2])) for m in meshes]
    with native.disabled():  # the numpy paths
        slow = [(faces_to_edge_index(m.faces, m.n_points), compute_node_labels(m),
                 periodic_boundary_pairs(m.points[:, :2])) for m in meshes]
    for i, (f, s) in enumerate(zip(fast, slow)):
        same = (np.array_equal(f[0], s[0]) and np.array_equal(f[1], s[1])
                and all(np.array_equal(a, b) for a, b in zip(f[2], s[2])))
        check(same, f"tools: native graph library differs from the numpy paths on mesh {i}")
    return native.build_seconds


def tools_generate(root: Path) -> None:
    """``cli.generate_main`` for each dataset of TOOLS_GENERATE, with each
    one's seconds and sample counts printed."""
    from p_div_gnn_tpu_torch import cli
    from p_div_gnn_tpu_torch.utils.configio import read_csv

    for kind, kw in TOOLS_GENERATE.items():
        t0 = time.perf_counter()
        cli.generate_main(["--dataset_path", str(root / kind), "--max_workers",
                           str(TOOLS_WORKERS), *generate_flags(kw)])
        seconds = time.perf_counter() - t0
        counts = {split: len(read_csv(root / kind / split / "dataset.csv")["n_nodes"])
                  for split in ("train", "test")}
        n_test = int(kw["n_samples"] * kw.get("test_size", 0.25))
        expect = {"train": kw["n_samples"] - n_test, "test": n_test}
        skipped = {s: expect[s] - counts[s] for s in expect}
        # only a Neo-Hookean solve may fail (and its sample is skipped)
        check(counts == expect or (kw.get("hyperelastic") and min(counts.values()) > 0),
              f"tools generate {kind}: {counts} samples, expected {expect}")
        nodes = sum(read_csv(root / kind / "test" / "dataset.csv")["n_nodes"])
        say(f"tools generate {kind}: {sum(counts.values())} samples ({counts}, skipped "
            f"{skipped}) in {seconds:.1f} s, {seconds / sum(counts.values()):.3f} s a sample "
            f"with {TOOLS_WORKERS} workers; test set {nodes} nodes")


def tools_infer(root: Path) -> dict:
    """``cli.infer_main`` of every committed checkpoint on its dataset's test
    set with fused3 (fp32): #1 launches 10 times a batch and nothing else
    does; every field within the serve allowance of ``Predictor`` on xla;
    the bf16 checkpoint also through ``Predictor`` with bf16 streams."""
    import json

    import numpy as np
    import torch

    from p_div_gnn_tpu_torch import cli
    from p_div_gnn_tpu_torch.graphs.dataset import MeshStressFieldDataset
    from p_div_gnn_tpu_torch.inference import Predictor
    from p_div_gnn_tpu_torch.utils.configio import read_config, read_csv

    folders, launches = {}, {k: 0 for k in launch_counts()}
    for name, config, kind in TOOLS_MODELS:
        cfg = read_config(ROOT / "scripts" / "configs_inference" / config)
        check(cfg["latent_size"] == LATENT and cfg["message_passing_steps"] == STEPS,
              f"{config} is no longer the flagship width: {cfg}")
        dataset_csv = root / kind / "test" / "dataset.csv"
        folders[name] = root / "infer" / name
        cfg.update(dataset_csv=str(dataset_csv), results_folder=str(folders[name]),
                   model_weights_path=str(checkpoint_of(cfg, name)), scatter_impl="fused3")
        path = root / f"infer_{name}.yml"
        path.write_text("".join(f"{k}: {v}\n" for k, v in cfg.items()))
        n = len(read_csv(dataset_csv)["n_nodes"])
        reset_launch_counts()
        t0 = time.perf_counter()
        cli.infer_main(["--config_path", str(path)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = launch_counts()
        expect = {k: 0 for k in got}
        expect["fused_edge3_fwd"] = STEPS * -(-n // cfg["batch_size"])
        check(got == expect, f"tools infer {name}: kernel launches {got}, expected {expect}")
        for k, v in got.items():
            launches[k] += v

        samples = MeshStressFieldDataset(read_csv(dataset_csv),
                                         periodic_graph=cfg["periodic_graph"]).samples
        ref = Predictor(cfg["model_weights_path"], LATENT, STEPS, scatter_impl="xla",
                        device="cuda")
        want = ref.predict(samples)
        table = read_csv(folders[name] / "dataset.csv")
        norm = json.loads((folders[name] / "normalize_params.json").read_text())
        z = lambda f: (f - norm["mean_local_stress"]) / norm["std_local_stress"]  # noqa: E731
        worst = share = 0.0
        for field, w, s in zip(table["data_filename"], want, samples, strict=True):
            g = np.load(field)["stress_field"]
            check(g.shape == (s.num_nodes, 3) and bool(np.isfinite(g).all()),
                  f"tools infer {name}: field {field} shape {g.shape} or non-finite")
            err = np.abs(z(g) - z(w))
            worst = max(worst, float(err.max()))
            share = max(share, float((err / (SERVE_ATOL + SERVE_RTOL * np.abs(z(w)))).max()))
        check(share <= 1.0, f"tools infer {name} fused3 vs Predictor xla: max abs err "
              f"{worst:.3e} (standardized), {share:.2f} of the allowance")
        line = (f"tools infer {name} ({config}, {n} meshes): {seconds:.2f} s, launches {got}; "
                f"vs Predictor xla max abs err {worst:.3e} (standardized), {share:.2f} of "
                f"the allowance")
        if name == "elast_200e_div_bf16":
            bf16 = Predictor(cfg["model_weights_path"], LATENT, STEPS, scatter_impl="fused3",
                             stream_dtype="bfloat16", device="cuda").predict(samples)
            err = max(float((np.abs(z(g) - z(w)) / (1.0 + np.abs(z(w)))).max())
                      for g, w in zip(bf16, want))
            check(err <= BF16_SERVE_TOL, f"tools {name}: Predictor fused3 bf16 vs xla fp32 "
                  f"{err:.3e} > {BF16_SERVE_TOL} (rtol = atol, standardized)")
            line += f"; Predictor fused3 bf16 vs xla fp32 {err:.3e} (rtol = atol {BF16_SERVE_TOL})"
        say(line)
        del ref
        torch.cuda.empty_cache()
    return {"folders": folders, "launches": launches}


def tools_compare(root: Path, folders: dict, card: str) -> None:
    """``cli.compare_main`` over each dataset's inference folders (no
    figures), its headline table held against the JAX package's figures."""
    import numpy as np

    from p_div_gnn_tpu_torch import cli
    from p_div_gnn_tpu_torch.utils.configio import read_csv

    failed = []
    for kind in TOOLS_COMPARE:
        names = [n for n, _, k in TOOLS_MODELS if k == kind]
        tables = cli.compare_main(["--dataset_csv", str(root / kind / "test" / "dataset.csv"),
                                   "--inference_folders", *[str(folders[n]) for n in names],
                                   "--model_names", *names])
        test_set = COMPARE_REFERENCE[kind]["test_set"]
        nodes = read_csv(root / kind / "test" / "dataset.csv")["n_nodes"]
        check({"meshes": len(nodes), "nodes": sum(nodes)} == test_set,
              f"tools compare {kind}: the generated test set has {len(nodes)} meshes of "
              f"{sum(nodes)} nodes, the JAX package's reference set {test_set}")
        for name in names:
            got = {k: float(np.mean(tables[name][col])) for k, col in COMPARE_COLUMNS.items()}
            want = COMPARE_REFERENCE[kind][name]
            rel = {k: abs(got[k] - want[k]) / abs(want[k]) for k in got}
            say(f"tools compare {kind} on {card}: {name}: mean NMSE (std) "
                f"{got['nmse_std']!r}, mean R2 {got['r2']!r}, mean Div(model) (std) "
                f"{got['div_model_std']!r}, mean Div(FEM) (std) {got['div_fem_std']!r}; "
                "rel. from the JAX package's " + " ".join(f"{k}={v:.2e}"
                                                          for k, v in rel.items()))
            failed += [f"{kind} {name} {k}: {got[k]!r} vs JAX {want[k]!r}"
                       for k in got if rel[k] > COMPARE_RTOL[k]]
    check(not failed, "tools compare outside the tolerance " + str(COMPARE_RTOL) + ": "
          + "; ".join(failed))


def tools_benchmark(card: str) -> None:
    """The GNN-vs-FEM sweep (linear) on the card: the mesher's node counts at
    factors 1 and 100, every time finite and positive."""
    from p_div_gnn_tpu_torch.analysis.benchmark import sweep

    t0 = time.perf_counter()
    rows = sweep(hyperelastic=False, steps=BENCH_STEPS, n_mean_steps=BENCH_MEAN_STEPS,
                 device="cuda", verbose=False)
    nodes = {r["hole_refinement_factor"]: r["n_nodes"] for r in rows}
    check(all(nodes.get(f) == n for f, n in BENCH_NODES.items()),
          f"tools benchmark: n_nodes by factor {nodes}, expected {BENCH_NODES} at the ends")
    for r in rows:
        check(all(math.isfinite(r[k]) and r[k] > 0 for k in ("gnn_gpu", "gnn_gpu_prepro", "fem")),
              f"tools benchmark: row {r}")
        say(f"tools benchmark on {card}: factor {r['hole_refinement_factor']!r} n_nodes "
            f"{r['n_nodes']} gnn_gpu {r['gnn_gpu'] * 1e3:.3f} ms gnn_gpu_prepro "
            f"{r['gnn_gpu_prepro'] * 1e3:.3f} ms fem {r['fem'] * 1e3:.3f} ms (xla forward, "
            f"means of {BENCH_MEAN_STEPS})")
    say(f"tools benchmark: {len(rows)} rows in {time.perf_counter() - t0:.1f} s")


def tools_pth(root: Path, request: list) -> dict:
    """The committed checkpoint exported to ``.pth`` by the port, read back,
    and one request served with fused3: bit-equal to the msgpack-loaded
    model's answer."""
    import numpy as np

    from p_div_gnn_tpu_torch.inference import Predictor
    from p_div_gnn_tpu_torch.models.torch_import import (
        load_torch_checkpoint,
        save_torch_checkpoint,
    )

    served = Predictor(CHECKPOINT, LATENT, STEPS, scatter_impl="fused3", device="cuda")
    want = served.predict(request)
    state_dict = {k: v.detach().cpu() for k, v in served.model.state_dict().items()}
    save_torch_checkpoint(root / "model_weights.pth", state_dict, served.stats, served.epoch)
    params, stats, epoch = load_torch_checkpoint(root / "model_weights.pth")
    check(epoch == served.epoch and stats == served.stats,
          f"tools .pth: epoch {epoch} stats {stats} read back, wrote {served.epoch} "
          f"{served.stats}")
    served.model.load_state_dict(params)
    served.stats = stats
    reset_launch_counts()
    got = served.predict(request)
    launches = launch_counts()
    same = all(np.array_equal(a, b) for a, b in zip(got, want, strict=True))
    check(same, "tools .pth: the request served from the .pth differs from the "
          "msgpack-loaded model's answer")
    say(f"tools .pth: {CHECKPOINT.parent.name} exported and read back "
        f"({(root / 'model_weights.pth').stat().st_size} bytes); a request of "
        f"{len(request)} meshes served with fused3 is bit-equal to the msgpack-loaded model's")
    return launches


def tools_phase(card: str, request: list) -> dict:
    """The user's tools on the card, through the port's CLI functions, in a
    temporary directory under build/: the native graph library, generate
    (four datasets), infer (six checkpoints, fused3), compare (against the
    JAX package's figures), the GNN-vs-FEM benchmark and the .pth round
    trip."""
    import shutil
    import tempfile

    import torch

    from p_div_gnn_tpu_torch.graphs.meshio import read_vtk
    from p_div_gnn_tpu_torch.utils.configio import read_csv

    t_start = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="tools_phase_", dir=ROOT / "build"))
    try:
        tools_generate(root)
        meshes = [read_vtk(p) for kind in ("elastic", "quad")
                  for p in read_csv(root / kind / "test" / "dataset.csv")["mesh_filename"][:4]]
        gxx = native_check(meshes)
        say(f"tools native: graph library built by g++ in {gxx:.2f} s (0 when built "
            f"earlier); edges, labels and periodic pairs array-equal to the numpy paths on "
            f"{len(meshes)} meshes")
        inferred = tools_infer(root)
        tools_compare(root, inferred["folders"], card)
        tools_benchmark(card)
        pth = tools_pth(root, request)
        launches = {k: inferred["launches"][k] + pth[k] for k in pth}
        torch.cuda.empty_cache()
        say(f"tools phase: {time.perf_counter() - t_start:.1f} s; kernel launches {launches}")
        return {"launches": launches}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def halo_bytes(ghost_rows: int, itemsize: int) -> int:
    """Bytes of ghost rows one rank receives in one train step: each of the
    STEPS message-passing steps exchanges LATENT-wide rows forward and their
    cotangents backward, and the loss exchanges the 3-wide prediction
    (fp32) once each way."""
    return 2 * STEPS * ghost_rows * LATENT * itemsize + 2 * ghost_rows * 3 * 4


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

    from p_div_gnn_tpu_torch.datagen.workload import build_samples, pack_workload
    from p_div_gnn_tpu_torch.graphs.batching import pack_batch
    from p_div_gnn_tpu_torch.ops import cuda_build

    # one nvcc per source, all started together
    t0 = time.perf_counter()
    libs = cuda_build.libraries("fused_edge3_fwd", "fused_edge3_bwd", "segment_sum_csr",
                                "fused_edge_fwd", "fused_edge_bwd", "fused_edge2_fwd",
                                "fused_edge2_bwd", "mgn_edge_fwd")
    say(f"build: {len(libs)} libraries in {time.perf_counter() - t0:.1f} s wall")
    for built in libs:
        say(f"build: {built.path.relative_to(ROOT)} in {built.build_seconds:.1f} s")
        for fig in ptxas_figures(built):
            say(f"build: {fig}")

    t0 = time.perf_counter()
    requests = [build_request(seed) for seed in REQUEST_SEEDS]
    say(f"requests: {len(requests)} x {N_MESHES} meshes built in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    samples = build_samples(N_MESHES, seed=0)
    t1 = time.perf_counter()
    host_train, n_real_edges, n_real_nodes = pack_workload(samples)
    t2 = time.perf_counter()
    host_pair = pack_workload(samples, pair_blocks=True)[0]
    t3 = time.perf_counter()
    train_batch, pair_batch = host_train.to("cuda"), host_pair.to("cuda")
    say(f"train batch: {N_MESHES} meshes with divergence operators, {n_real_nodes} nodes, "
        f"{n_real_edges} edges, Np={host_train.num_nodes_padded} "
        f"Ep={host_train.num_edges_padded} Ep2={host_train.snd_perm.shape[0]}; pair-blocked "
        f"Ep={host_pair.num_edges_padded} ({len(host_pair.edge_block_tile)} blocks) "
        f"Ep2={host_pair.snd_perm.shape[0]}; meshes {t1 - t0:.1f} s, packed in "
        f"{t2 - t1:.1f} s and {t3 - t2:.1f} s")

    batch = pack_batch(requests[0], reorder="rcm", sender_view=False,
                       div_ell=False).to("cuda")
    kern = kernel_phase(batch)
    v2 = v2_kernel_phase(batch)
    bwd = backward_kernel_phase(train_batch)
    v2_bwd = v2_backward_kernel_phase(train_batch)
    csr = segment_sum_kernel_phase(train_batch)
    pair = {view: pair_kernel_phase(b, view)
            for view, b in (("fused", train_batch), ("fused2", pair_batch))}
    f2 = fused2_kernel_phase(pair_batch)
    f2_bwd = fused2_backward_kernel_phase(pair_batch)
    mgn_kern = mgn_edge_kernel_phase(train_batch)
    t0 = time.perf_counter()
    wide_ms = width_phase()
    say(f"width phase: {time.perf_counter() - t0:.1f} s; fused kernels at L={max(WIDTHS)} "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in wide_ms.items()))
    serve = serve_phase(requests)
    train = train_phase(train_batch, pair_batch, n_real_edges, smi)
    mgn_train = mgn_train_phase(samples, smi)
    graphcast_train = graphcast_train_phase(smi)
    t0 = time.perf_counter()
    cli = cli_phase(smi)
    say(f"cli phase: {time.perf_counter() - t0:.1f} s")
    parallel = parallel_phase(samples, host_train, train_batch, smi)
    tools = tools_phase(smi, requests[0])

    def row(name: str, source: str, replaces: str | None, launches: int, res: dict) -> dict:
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": res["max_abs_err"], "ms": res["ms"],
                "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
                "bound_by": res["bound_by"], "library_ms": res.get("library_ms")}

    # launches: the serve paths', the train paths' (MeshGraphNets' too), the
    # cli runs', the parallel ranks' and the tools phase's, each counted from
    # 0 (serving launches only the forwards)
    launches = dict(train["launches"])
    for counts in [impl["launches"] for impl in serve["impls"].values()] + [
            mgn_train["launches"], graphcast_train["launches"], cli["launches"],
            parallel["launches"], tools["launches"]]:
        for k, v in counts.items():
            launches[k] += v
    # #4 runs on two sender views: its row gives the receiver-major one's
    # fp32 numbers (the largest fp32 error of both), its bf16 numbers under
    # "bfloat16", and each view's in "views"
    by_impl = train["launches_by_impl"]
    pair_row = dict(pair["fused"]["float32"],
                    max_abs_err=max(v["float32"]["max_abs_err"] for v in pair.values()))
    pair_views = [dict(res, view=view, launches=by_impl[view]["segment_sum_csr_pair"])
                  for view, res in pair.items()]
    rows = (
        ("fused_edge3_fwd", "fused_edge3_fwd.cu", "p_div_gnn_tpu/ops/fused_edge3.py:94", kern),
        ("fused_edge3_bwd", "fused_edge3_bwd.cu", "p_div_gnn_tpu/ops/fused_edge3.py:245", bwd),
        ("segment_sum_csr", "segment_sum_csr.cu", "p_div_gnn_tpu/ops/scatter_pallas.py:56", csr),
        ("segment_sum_csr_pair", "segment_sum_csr.cu",
         "p_div_gnn_tpu/ops/scatter_pallas.py:170", {"float32": pair_row}),
        ("fused_edge_fwd", "fused_edge_fwd.cu", "p_div_gnn_tpu/ops/fused_edge.py:157", v2),
        ("fused_edge_bwd", "fused_edge_bwd.cu", "p_div_gnn_tpu/ops/fused_edge.py:333", v2_bwd),
        ("fused_edge2_fwd", "fused_edge2_fwd.cu", "p_div_gnn_tpu/ops/fused_edge.py:600", f2),
        ("fused_edge2_bwd", "fused_edge2_bwd.cu", "p_div_gnn_tpu/ops/fused_edge.py:763",
         f2_bwd),
        ("mgn_edge_fwd", "mgn_edge_fwd.cu", None, {"float32": mgn_kern}),
    )
    kernel_rows = [
        row(name, f"p_div_gnn_tpu_torch/csrc/{src}", replaces, launches[name], res["float32"])
        for name, src, replaces, res in rows]
    pair_out = next(r for r in kernel_rows if r["name"] == "segment_sum_csr_pair")
    pair_out["bfloat16"] = {k: pair["fused"]["bfloat16"][k] for k in (
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    pair_out["views"] = pair_views
    say(json.dumps({"kernels": kernel_rows}))
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
