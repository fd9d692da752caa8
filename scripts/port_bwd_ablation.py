"""Where a one-pass backward's time goes on the card: each sub-kernel's
device time with one part of its work taken out.

    PYTHONPATH=. python scripts/port_bwd_ablation.py
        [--kernel fused_edge3_bwd|fused_edge_bwd|fused_edge2_bwd]

Builds ``p_div_gnn_tpu_torch/csrc/<kernel>.cu`` (default the fused3 backward,
#2; the v2 backward #6, the pair-blocked backward #8) as it is ("base") and
in variants with one part of its work taken out by a preprocessor switch
(``-DPDG_WITHOUT=<part>``, a name of ``csrc/fused3_tile.cuh``'s ``enum Part``),
through ``ops/cuda_build.py`` (its nvcc flags and build directory, one build
a variant, in parallel), and runs the wrapper on each through
``cuda_build.using``: the weight-grad kernel without its MMAs, without
splitting the staged rows into bf16 terms and without fetching them; the
tile kernel without its tensor-core MMAs, without its FMA chains (and the shared loads
that feed them), and for #6 and #8 without the first layer's receiver and
sender rows and without the receiver run sums. Each runs chip_smoke.py's backward kernel
phase inputs (the flagship training batch, receiver-major or
pair-blocked, that phase's generator seed) in fp32 and bf16 streams, three
calls under ``torch.profiler``, and prints each sub-kernel's mean device
time in ms. The variants compute wrong values; only their times are read.
Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from p_div_gnn_tpu_torch.datagen.workload import build_workload  # noqa: E402
from p_div_gnn_tpu_torch.ops import cuda_build, fused_edge, fused_edge3  # noqa: E402

# each kernel's sub-kernels (csrc/bwd_common.cuh's are shared)
SHARED = ("prepare_weights_kernel", "bwd_wgrad_kernel", "bwd_reduce_kernel")
SUBS = {"fused_edge3_bwd": ("step3_bwd_tile_kernel",) + SHARED,
        "fused_edge_bwd": ("v2_bwd_tile_kernel",) + SHARED,
        "fused_edge2_bwd": ("pair_bwd_tile_kernel", "zero_rows_kernel") + SHARED}
# variant: the part it is built without (csrc/fused3_tile.cuh, enum Part)
VARIANTS = {
    "base": None,
    "wgrad without MMAs": "WITHOUT_WG_MMA",
    "wgrad without the term split": "WITHOUT_WG_SPLIT",
    "wgrad without fetching": "WITHOUT_WG_FETCH",
    "tile without MMAs": "WITHOUT_MMA",
    "tile without FMA chains": "WITHOUT_FMA",
}
V2_VARIANTS = {**VARIANTS, "tile without the row gathers": "WITHOUT_GATHER",
               "tile without the run sums": "WITHOUT_RUNS"}


def build_variants(kernel: str, variants: dict, extra: dict | None = None
                   ) -> dict[str, tuple[str, ...]]:
    """Builds csrc/<kernel>.cu once per variant, in parallel, with
    -DPDG_WITHOUT=<its part> (none for None) and the variant's ``extra``
    defines; returns each variant's defines."""
    defines = {name: (() if part is None else (f"PDG_WITHOUT={part}",))
               + tuple((extra or {}).get(name, ())) for name, part in variants.items()}
    cuda_build.libraries(*((kernel, d) for d in defines.values()))
    return defines


def variant(kernel: str, defines: tuple[str, ...]):
    """A block in which the wrappers launch csrc/<kernel>.cu built with
    ``defines`` (every other library as built)."""
    return cuda_build.using(lambda name, d: cuda_build.load_cuda_library(
        name, d + defines if name == kernel else d))


def calls(kernel: str):
    """The kernel phase's inputs: yields (dtype name, a call of the
    wrapper)."""
    pair = kernel == "fused_edge2_bwd"
    batch = build_workload(chip_smoke.N_MESHES, seed=0, pair_blocks=pair)[0].to("cuda")
    Np, Ep, L = batch.num_nodes_padded, batch.num_edges_padded, chip_smoke.LATENT
    seed = {"fused_edge3_bwd": 1, "fused_edge_bwd": 4, "fused_edge2_bwd": 7}[kernel]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    make = {"fused_edge3_bwd": chip_smoke.edge_step_inputs,
            "fused_edge_bwd": chip_smoke.v2_step_inputs,
            "fused_edge2_bwd": chip_smoke.pair_step_inputs}[kernel]
    base = make(batch, gen)
    dz, dr, dm = (torch.randn(s, generator=gen, device="cuda") for s in ((Ep, L), (Np, L), (8, L)))
    aux = (batch.edge_gid, batch.edge_block_tile)
    for sd_name, sd in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        args = [base[k].to(sd).contiguous() for k in base]
        if kernel == "fused_edge3_bwd":
            z = fused_edge3.fused_edge_step3_reference(*args, batch.receivers, batch.edge_gid,
                                                       batch.n_graphs)[0]
            cots = (z, dz.to(sd), dr, dm)
            yield sd_name, lambda: fused_edge3.fused_edge_step3_backward(
                *args, batch.receivers, aux, batch.n_graphs, batch.tile, *cots)
        elif kernel == "fused_edge_bwd":
            z = fused_edge.fused_edge_step_reference(*args, batch.receivers, batch.edge_gid,
                                                     batch.n_graphs)[0]
            cots = (z, dz.to(sd), dr, dm)
            yield sd_name, lambda: fused_edge.fused_edge_step_backward(
                *args, batch.receivers, aux, batch.n_graphs, batch.tile, *cots)
        else:
            idx = (batch.receivers, batch.senders, chip_smoke.pair_aux(batch), batch.n_graphs,
                   batch.tile)
            z = fused_edge.fused_edge_step2_reference(*args, *idx)[0]
            cots = (z, dz.to(sd), dr, dm)
            yield sd_name, lambda: fused_edge.fused_edge2_bwd(*args, *idx, *cots)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", default="fused_edge3_bwd", choices=tuple(SUBS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    kernel = args.kernel
    defines = build_variants(kernel, VARIANTS if kernel == "fused_edge3_bwd" else V2_VARIANTS)
    subs = SUBS[kernel]
    for name, d in defines.items():
        with variant(kernel, d):
            for sd_name, call in calls(kernel):
                for _ in range(2):
                    call()
                torch.cuda.synchronize()
                with torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                    for _ in range(3):
                        call()
                    torch.cuda.synchronize()
                times = {sub: 0.0 for sub in subs}
                for e in prof.key_averages():
                    for sub in subs:
                        if sub in e.key:
                            times[sub] += e.device_time_total / 3e3
                print(f"{kernel} {name} {sd_name}: "
                      + " ".join(f"{k} {v:.3f}" for k, v in times.items())
                      + f" ms; sum {sum(times.values()):.3f} ms", flush=True)
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
