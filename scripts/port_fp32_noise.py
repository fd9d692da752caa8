"""How far the port's fp32 forward, or its fp32 training gradient, is from
the same model in fp64, at the flagship size.

    PYTHONPATH=. python scripts/port_fp32_noise.py [--device cpu|cuda] [--seed 0]
    PYTHONPATH=. python scripts/port_fp32_noise.py --grad [--device cpu|cuda]
        [--ref-device cpu|cuda] [--n-graphs 16]
        [--impls fused3,fused,fused2,pallas,hybrid]
    PYTHONPATH=. python scripts/port_fp32_noise.py --split [--tiles 3] [--seed 0]
    PYTHONPATH=. python scripts/port_fp32_noise.py --split --flagship --device cuda

Forward mode (default): builds one serving request as ``chip_smoke.py`` does
(16 meshes, RCM packing, the committed checkpoint), then prints, in
standardized output units, the max abs difference and its share of the
fused3-vs-xla allowance (atol 2e-5 + rtol 2e-4·|ref|) for: fp32 ``xla`` vs
fp64 ``xla``; fp32 ``xla`` with its matmuls in fp64 vs fp64; fp32 ``fused3``
vs fp64; fp32 ``fused3`` vs fp32 ``xla``; and the largest edge and node
latents after each message-passing step (fp64 run).

Gradient mode (``--grad``): the step-1 loss gradient of ``chip_smoke.py``'s
training phase (the benchmark's model from ``torch.Generator`` seed 0,
``NormStats.ones()``, NMSE + 10 x divergence, on ``build_workload``'s
batch; fused2 runs on the same meshes packed pair-blocked). It computes the gradient of the fp64 ``xla`` model on
``--ref-device`` (per-step remat keeps its memory small) and, on
``--device``, of fp32 ``xla`` (twice: its gathers' backward adds with
atomics on the card) and of each fp32 impl of ``--impls`` (default
fused3); it prints, for each parameter tensor, ``||g - g_ref|| / ||g_ref||``
of each fp32 path against fp64 and of each impl against xla, and the
largest of each over the parameters. Those are what the training phase's
gradient tolerance is derived from.

Split mode (``--split``, on the CPU): how far the fused3 backward's outputs
land from fp64 when its L×L products run on bf16 tensor cores in fp32
stream mode, for each way of splitting the fp32 operands: ``bf16x6``
(three bf16 terms each, the six cross products of terms i + j <= 2, what
Mosaic lowers Precision.HIGHEST to and csrc/fused_edge3_bwd.cu runs),
``bf16x3`` (two terms, three products), ``3xTF32`` (a TF32 term and its
TF32 remainder, three products) and plain fp32 (``torch`` matmul). Each
product accumulates fp32-rounded k16 partials in fp32, as the tensor cores
do; the weight grads sum such fp32 partials over 32 slots, then in fp64.
On random inputs of ``--tiles`` node tiles at L = 128 (the card tests'
problem, tests/test_torch_port_cuda.py), it prints each output's max abs
error against the same backward in fp64 and its share of the kernel check
(rtol = atol = 2e-4 of chip_smoke.BWD_TOL), with the relu gates of the fp64
run (a gate within rounding of 0 would flip between any two fp32 orders;
the kernel decides those on the plain version's FMA chains): the basis for
the fp32 scheme. With ``--flagship`` it takes chip_smoke.py's backward kernel
phase inputs instead (build that batch on the card: ``--device cuda``) and
prints the plain fp32 version and the CUDA kernel against fp64 (with the
plain version's relu gates) and the kernel against the plain version.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import sys
from pathlib import Path

import torch
from torch.overrides import TorchFunctionMode

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from p_div_gnn_tpu_torch.graphs.batching import pack_batch  # noqa: E402
from p_div_gnn_tpu_torch.inference import Predictor  # noqa: E402


class Fp64Matmul(TorchFunctionMode):
    """Runs every fp32 matmul in fp64 and rounds the product once."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in (torch.matmul, torch.Tensor.matmul) and args[0].dtype == torch.float32:
            return func(args[0].double(), args[1].double()).float()
        return func(*args, **(kwargs or {}))


def grad_noise(args: argparse.Namespace) -> None:
    from p_div_gnn_tpu_torch.datagen.workload import build_samples, pack_workload

    impls = args.impls.split(",")
    samples = build_samples(args.n_graphs, seed=args.seed)
    host, n_edges, n_nodes = pack_workload(samples)
    hosts = {False: host}
    if "fused2" in impls:
        hosts[True] = pack_workload(samples, pair_blocks=True)[0]
    print(f"batch: {args.n_graphs} meshes, {n_nodes} nodes, {n_edges} edges, "
          f"Np={host.num_nodes_padded} Ep={host.num_edges_padded}", flush=True)

    def grads(impl: str, device: str, dtype: torch.dtype, remat: bool):
        batch = hosts[impl == "fused2"].to(device)
        if dtype == torch.float64:
            batch = dataclasses.replace(batch, **{
                f: getattr(batch, f).double() for f in (
                    "pos", "mean_stress", "node_type", "local_stress", "edge_weight",
                    "div_data", "div_val", "divT_val")})
        trainer = chip_smoke.make_trainer(impl, "float32", device)
        trainer.model.remat_steps = remat
        trainer.model.to(dtype)
        aux, g = trainer.loss_and_grads(batch)
        out = {n: v.detach().double().cpu() for n, v in g.items()}
        total = float(aux["total"])
        del trainer, batch, g
        if device.startswith("cuda"):
            torch.cuda.empty_cache()
        return total, out

    l64, ref = grads("xla", args.ref_device, torch.float64, remat=True)
    runs = {"xla fp32": grads("xla", args.device, torch.float32, remat=False),
            "xla fp32 (again)": grads("xla", args.device, torch.float32, remat=False)}
    for impl in impls:
        runs[f"{impl} fp32"] = grads(impl, args.device, torch.float32, remat=False)

    def rel(a: dict, b: dict) -> dict:
        return {n: float((a[n] - b[n]).norm() / b[n].norm().clamp_min(1e-300)) for n in b}

    table = {f"{name} vs fp64": rel(g, ref) for name, (_, g) in runs.items()}
    for impl in impls:
        table[f"{impl} fp32 vs xla fp32"] = rel(runs[f"{impl} fp32"][1], runs["xla fp32"][1])
    table["xla fp32 vs xla fp32 (again)"] = rel(runs["xla fp32 (again)"][1],
                                                runs["xla fp32"][1])
    print(f"loss fp64 {l64!r}; " + "; ".join(
        f"{name} {lo!r} (rel {abs(lo - l64) / abs(l64):.3e})"
        for name, (lo, _) in runs.items()), flush=True)
    print("parameter " + " | ".join(table), flush=True)
    for n in ref:
        print(f"{n} " + " | ".join(f"{t[n]:.3e}" for t in table.values()), flush=True)
    for name, t in table.items():
        worst = max(t, key=t.get)
        print(f"max over parameters, {name}: {t[worst]:.3e} ({worst})", flush=True)


def split_terms(x: torch.Tensor, scheme: str) -> list[torch.Tensor]:
    """fp32 x as the scheme's terms (fp32 tensors holding bf16 / TF32 values)."""
    def bf16(v):
        return v.to(torch.bfloat16).float()

    def tf32(v):  # round to nearest with a 10-bit mantissa
        bits = v.view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    rnd, n = {"bf16x6": (bf16, 3), "bf16x3": (bf16, 2), "3xTF32": (tf32, 2)}[scheme]
    terms, r = [], x
    for _ in range(n):
        t = rnd(r)
        terms.append(t)
        r = r - t
    return terms


SCHEME_PAIRS = {"bf16x6": ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)),
                "bf16x3": ((1, 0), (0, 1), (0, 0)), "3xTF32": ((1, 0), (0, 1), (0, 0))}


def tc_matmul(a: torch.Tensor, b: torch.Tensor, scheme: str) -> torch.Tensor:
    """a @ b (fp32) as the tensor cores form it under the scheme: each k16
    partial of each term pair exact, rounded to fp32, added in fp32."""
    if scheme == "fp32":
        return a @ b
    ta, tb = split_terms(a, scheme), split_terms(b, scheme)
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32, device=a.device)
    for k in range(0, a.shape[1], 16):
        for i, j in SCHEME_PAIRS[scheme]:
            acc = acc + (ta[i][:, k:k + 16].double() @ tb[j][k:k + 16].double()).float()
    return acc


def split_backward(args: tuple, scheme: str, dtype: torch.dtype, gates=None, n_graphs: int = 1):
    """The fused3 backward (fused_edge_step3_backward_reference's formulas)
    with every product under ``scheme``, or all in fp64 (dtype float64).
    The relu gates (pre1 > 0, pre2 > 0, z_msg > 0) are taken from ``gates``
    where given (the kernel decides a gate within rounding of 0 on the plain
    version's FMA chains); returns the outputs and the gates."""
    (x, g, e, wu, wv, we, b0, w2, b2, rcv, gid, z_upd, dz, dr, dm) = args
    if dtype == torch.float64:
        x, g, e, wu, wv, we, b0, w2, b2, z_upd, dz, dr, dm = (
            t.double() for t in (x, g, e, wu, wv, we, b0, w2, b2, z_upd, dz, dr, dm))

        def mm(p, q):
            return p @ q

        def wsum(*pairs):
            return sum(p.T @ q for p, q in pairs)
    else:
        def mm(p, q):
            return tc_matmul(p, q, scheme)

        def wsum(*pairs):  # fp32 partials over 32 slots, fp64 across them
            out = 0.0
            for p, q in pairs:
                for s0 in range(0, p.shape[0], 32):
                    out = out + tc_matmul(p[s0:s0 + 32].T.contiguous(), q[s0:s0 + 32],
                                          scheme).double()
            return out
    mask = (gid < n_graphs).to(x.dtype)[:, None]
    xr = x.index_select(0, rcv)
    ep = mm(e, we)
    pre1 = mm(xr, wu) + mm(g, wv) + ep + b0
    pre2 = mm(xr, wv) + mm(g, wu) + ep + b0
    on1, on2 = (pre1 > 0, pre2 > 0) if gates is None else gates[:2]
    h1, h2 = pre1 * on1, pre2 * on2
    zm = torch.relu(mm(h1, w2) + b2) * mask
    zon = zm > 0 if gates is None else gates[2]
    dy1 = (dr.index_select(0, rcv) + dm[0] + 2 * dm[1] * zm) * zon
    dy2 = (dz + dm[2] + 2 * dm[3] * z_upd) * (z_upd > 0)
    dp1 = mm(dy1, w2.T.contiguous()) * on1
    dp2 = mm(dy2, w2.T.contiguous()) * on2
    dps = dp1 + dp2
    dxr = mm(dp1, wu.T.contiguous()) + mm(dp2, wv.T.contiguous())
    dx = torch.zeros_like(x, dtype=torch.float64).index_add_(0, rcv, dxr.double())
    return [dx, mm(dp1, wv.T.contiguous()) + mm(dp2, wu.T.contiguous()), mm(dps, we.T.contiguous()),
            wsum((xr, dp1), (g, dp2)), wsum((xr, dp2), (g, dp1)), wsum((e, dps)),
            dps.double().sum(0), wsum((h1, dy1), (h2, dy2)),
            (dy1 + dy2).double().sum(0)], (on1, on2, zon)


def flagship_backward_inputs(device: str) -> tuple:
    """chip_smoke.py's backward kernel phase inputs: the training batch,
    random edge-step inputs (generator seed 1) and cotangents, fp32."""
    from p_div_gnn_tpu_torch.datagen.workload import build_workload
    from p_div_gnn_tpu_torch.ops.fused_edge3 import fused_edge_step3_reference

    batch = build_workload(16, seed=0)[0].to(device)
    gen = torch.Generator(device=device).manual_seed(1)
    base = chip_smoke.edge_step_inputs(batch, gen)
    Np, Ep, L = batch.num_nodes_padded, batch.num_edges_padded, chip_smoke.LATENT
    dz, dr, dm = (torch.randn(shape, generator=gen, device=device)
                  for shape in ((Ep, L), (Np, L), (8, L)))
    t = [base[k].contiguous() for k in base]
    z_upd = fused_edge_step3_reference(*t, batch.receivers, batch.edge_gid, batch.n_graphs)[0]
    return batch, (*t, batch.receivers.long(), batch.edge_gid, z_upd, dz, dr, dm)


def split_noise(args: argparse.Namespace) -> None:
    from p_div_gnn_tpu_torch.ops import fused_edge3

    names = ("dx", "dg", "de", "dWu", "dWv", "dWe", "db0", "dW2", "db2")
    tol = chip_smoke.BWD_TOL["float32"]

    def shares(got, ref) -> str:
        parts, worst = [], 0.0
        for name, a, b in zip(names, got, ref):
            err = (a.double() - b.double()).abs()
            share = float((err / (tol * (1.0 + b.double().abs()))).max())
            worst = max(worst, share)
            parts.append(f"{name} {float(err.max()):.3e} ({share:.3f})")
        return ", ".join(parts) + f"; largest share {worst:.3f}"

    if args.flagship:
        batch, inputs = flagship_backward_inputs(args.device)
        # fp64 with the gates of the fp32 products (the plain version's)
        _, gates = split_backward(inputs, "fp32", torch.float32, n_graphs=batch.n_graphs)
        ref, _ = split_backward(inputs, "fp64", torch.float64, gates, batch.n_graphs)
        x, g, e, wu, wv, we, b0, w2, b2, rcv, gid, z_upd, dz, dr, dm = inputs
        rcv32 = rcv.int()
        plain = fused_edge3.fused_edge_step3_backward_reference(
            x, g, e, wu, wv, we, b0, w2, b2, rcv32, gid, batch.n_graphs, z_upd, dz, dr, dm)
        print(f"fused3 backward, flagship training batch (Ep={z_upd.shape[0]}, L=128) on "
              f"{args.device}: max abs error (share of rtol = atol = {tol:g})", flush=True)
        print("plain fp32 vs fp64: " + shares(plain, ref), flush=True)
        if args.device.startswith("cuda"):
            kern = fused_edge3.fused_edge_step3_backward(
                x, g, e, wu, wv, we, b0, w2, b2, rcv32, (gid, batch.edge_block_tile),
                batch.n_graphs, batch.tile, z_upd, dz, dr, dm)
            print("kernel vs fp64: " + shares(kern, ref), flush=True)
            print("kernel vs plain fp32: " + shares(kern, plain), flush=True)
        return

    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))
    from test_torch_port_cuda import _edge_problem

    arrays, idx = _edge_problem(args.seed, args.tiles, 128)
    t = [torch.from_numpy(v) for v in arrays.values()]
    rcv, gid = (torch.from_numpy(idx[k]).long() for k in ("receivers", "edge_gid"))
    z_upd = fused_edge3.fused_edge_step3_reference(*t, rcv, gid, 1)[0]
    gen = torch.Generator().manual_seed(args.seed + 7)
    cots = (torch.randn(z_upd.shape, generator=gen), torch.randn(t[0].shape, generator=gen),
            torch.randn((8, 128), generator=gen))
    inputs = (*t, rcv, gid, z_upd, *cots)
    ref, gates = split_backward(inputs, "fp64", torch.float64)
    print(f"fused3 backward, {args.tiles} node tiles, Ep={z_upd.shape[0]}, L=128: max abs "
          f"error against fp64 (share of rtol = atol = {tol:g})", flush=True)
    for scheme in ("fp32", "bf16x6", "bf16x3", "3xTF32"):
        got, _ = split_backward(inputs, scheme, torch.float32, gates)
        print(f"{scheme}: " + shares(got, ref), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--grad", action="store_true", help="gradient mode")
    ap.add_argument("--ref-device", default="cpu", help="device of the fp64 gradient")
    ap.add_argument("--n-graphs", type=int, default=16, help="meshes (gradient mode)")
    ap.add_argument("--impls", default="fused3",
                    help="comma-separated impls held against xla (gradient mode)")
    ap.add_argument("--split", action="store_true", help="split mode (fp32 tensor-core schemes)")
    ap.add_argument("--tiles", type=int, default=3, help="node tiles (split mode)")
    ap.add_argument("--flagship", action="store_true",
                    help="split mode on chip_smoke's training batch (plain version, kernel)")
    args = ap.parse_args()
    if args.grad:
        grad_noise(args)
        return
    if args.split:
        split_noise(args)
        return

    host = pack_batch(chip_smoke.build_request(args.seed), reorder="rcm",
                      sender_view=False, div_ell=False)
    batch = host.to(args.device)
    real = torch.as_tensor(host.node_gid < host.n_graphs, device=args.device)
    xla = Predictor(chip_smoke.CHECKPOINT, scatter_impl="xla", device=args.device)
    fused = Predictor(chip_smoke.CHECKPOINT, scatter_impl="fused3", device=args.device)
    stats = xla.stats

    @torch.no_grad()
    def run(model, b):
        return model(b, stats, scale_output=False)[real].double()

    b64 = dataclasses.replace(
        batch, pos=batch.pos.double(), mean_stress=batch.mean_stress.double(),
        node_type=batch.node_type.double(), edge_weight=batch.edge_weight.double(),
    )
    m64 = copy.deepcopy(xla.model).double()
    ref = run(m64, b64)
    x32 = run(xla.model, batch)
    with Fp64Matmul():
        x32_mm64 = run(xla.model, batch)
    f32 = run(fused.model, batch)

    def report(name: str, a: torch.Tensor, b: torch.Tensor) -> None:
        err = (a - b).abs()
        share = (err / (chip_smoke.SERVE_ATOL + chip_smoke.SERVE_RTOL * b.abs())).max()
        print(f"{name}: max abs {err.max().item():.3e}, "
              f"{share.item():.2f} of the allowance", flush=True)

    report("xla fp32 vs fp64", x32, ref)
    report("xla fp32, matmuls in fp64, vs fp64", x32_mm64, ref)
    report("fused3 fp32 vs fp64", f32, ref)
    report("fused3 fp32 vs xla fp32", f32, x32)

    with torch.no_grad():
        mean_stress = (b64.mean_stress - stats.mean_mean_stress) / stats.std_mean_stress
        pos = (b64.pos - stats.mean_pos) / stats.std_pos
        x = m64.node_encoder(torch.cat([mean_stress, pos, b64.node_type], -1), b64.node_mask)
        e = m64.edge_encoder((b64.edge_weight - stats.mean_edge_weight)
                             / stats.std_edge_weight, b64.edge_mask)
        for step in range(m64.message_passing_steps):
            x, e = m64.processor(x, e, b64)
            print(f"step {step}: max |x| {x.abs().max().item():.2f}, "
                  f"max |e| {e.abs().max().item():.2f}")


if __name__ == "__main__":
    main()
