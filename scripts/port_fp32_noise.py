"""How far the port's fp32 forward is from the same model in fp64, at the
flagship serving size with the committed checkpoint.

    PYTHONPATH=. python scripts/port_fp32_noise.py [--device cpu|cuda] [--seed 0]

Builds one request as ``chip_smoke.py`` does (16 meshes, RCM packing), then
prints, in standardized output units, the max abs difference and its share
of the fused3-vs-xla allowance (atol 2e-5 + rtol 2e-4·|ref|) for:
fp32 ``xla`` vs fp64 ``xla``; fp32 ``xla`` with its matmuls in fp64 vs fp64;
fp32 ``fused3`` vs fp64; fp32 ``fused3`` vs fp32 ``xla``; and the largest
edge and node latents after each message-passing step (fp64 run).
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

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
