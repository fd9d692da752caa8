"""How far the port's fp32 forward, or its fp32 training gradient, is from
the same model in fp64, at the flagship size.

    PYTHONPATH=. python scripts/port_fp32_noise.py [--device cpu|cuda] [--seed 0]
    PYTHONPATH=. python scripts/port_fp32_noise.py --grad [--device cpu|cuda]
        [--ref-device cpu|cuda] [--n-graphs 16]
        [--impls fused3,fused,fused2,pallas,hybrid]

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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--grad", action="store_true", help="gradient mode")
    ap.add_argument("--ref-device", default="cpu", help="device of the fp64 gradient")
    ap.add_argument("--n-graphs", type=int, default=16, help="meshes (gradient mode)")
    ap.add_argument("--impls", default="fused3",
                    help="comma-separated impls held against xla (gradient mode)")
    args = ap.parse_args()
    if args.grad:
        grad_noise(args)
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
