"""Where an edge-step forward's time goes on the card: the tile kernel's
device time with one part of its work taken out, and how evenly its parts
end.

    PYTHONPATH=. python scripts/port_fwd_ablation.py
        [--kernel fused_edge3_fwd|fused_edge_fwd|fused_edge2_fwd]

Builds ``p_div_gnn_tpu_torch/csrc/<kernel>.cu`` (default the fused3
forward, #1; the v2 forward #5, the pair-blocked forward #7) as it is
("base") and in variants with one part of its work taken out by a
preprocessor switch (``-DPDG_WITHOUT=<part>``, a name of
``csrc/fused3_tile.cuh``'s ``enum Part``), through ``ops/cuda_build.py``
(``port_bwd_ablation.build_variants`` and ``variant``):
without the FMA chains (fp32: the FMAs, and the shared loads that feed
them), without staging the step's rows (fp32), without the MMAs (bf16),
without copying the step's rows (bf16), for #5 and #7 without gathering the
first layer's receiver and sender rows (fp32), and, in both dtypes, without
the R run sums, without the moment sums, and without the column walks (R,
M and the z_upd stores). Each runs chip_smoke.py's kernel phase inputs for
that kernel (#1 and #5: the serving batch of request 0; #7: the
pair-blocked training batch; that phase's generator seed) in fp32 and bf16
streams, five calls under ``torch.profiler``, and prints the mean device
time of each sub-kernel in ms. The variants compute wrong values; only
their times are read.

Then a build with ``-DPDG_PART_CLOCK=1`` (the outputs unchanged) records
each CTA's first and last ``%globaltimer`` reading of a call: the script
prints, per dtype, the span of the launch (first start to last end), the
longest, mean and shortest CTA time, and the longest against the mean (the
share of the launch the parts' imbalance costs is at most 1 − mean /
longest). Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke  # noqa: E402
from p_div_gnn_tpu_torch.graphs.batching import pack_batch  # noqa: E402
from p_div_gnn_tpu_torch.ops import cuda_build, fused_edge, fused_edge3  # noqa: E402
from port_bwd_ablation import build_variants, variant  # noqa: E402

SUBS = {"fused_edge3_fwd": ("copy_weights_kernel", "step3_fwd_fma_kernel",
                            "step3_fwd_mma_kernel", "moments_reduce_kernel"),
        "fused_edge_fwd": chip_smoke.V2_FWD_SUBS,
        "fused_edge2_fwd": chip_smoke.V2_FWD_SUBS}
# variant: the part it is built without (csrc/fused3_tile.cuh, enum Part)
VARIANTS = {
    "base": None,
    "without FMA chains": "WITHOUT_FMA",
    "without staging the rows": "WITHOUT_STAGE",
    "without MMAs": "WITHOUT_MMA",
    "without copying the rows": "WITHOUT_COPY",
    "without the R runs": "WITHOUT_RUNS",
    "without the moment sums": "WITHOUT_MOMENTS",
    "without the column walks": "WITHOUT_COLUMNS",
    "part clock": None,
}
V2_VARIANTS = {**VARIANTS, "without the row gathers": "WITHOUT_GATHER"}
EXTRA = {"part clock": ("PDG_PART_CLOCK=1",)}


def part_times(built: cuda_build.CudaLibrary, kernel: str, call) -> str:
    """One call's CTA times from the part clock build."""
    n_parts = int(getattr(built.lib, f"pdg_{kernel}_parts")())
    call()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (2 * n_parts))()
    err = built.lib.pdg_part_clock(buf, n_parts)
    cuda_build.check_launch(built, err, "pdg_part_clock")
    starts, ends = buf[0::2], buf[1::2]
    spans = [(e - s) / 1e6 for s, e in zip(starts, ends)]
    mean = statistics.fmean(spans)
    return (f"launch span {(max(ends) - min(starts)) / 1e6:.4f} ms over {n_parts} CTAs; "
            f"CTA time longest {max(spans):.4f} mean {mean:.4f} shortest {min(spans):.4f} ms; "
            f"longest / mean {max(spans) / mean:.3f}")


def calls(kernel: str):
    """(dtype name, call) pairs: the kernel's wrapper on its chip_smoke
    phase's inputs, in fp32 and bf16 streams."""
    if kernel == "fused_edge2_fwd":
        from p_div_gnn_tpu_torch.datagen.workload import build_workload

        batch = build_workload(chip_smoke.N_MESHES, seed=0, pair_blocks=True)[0].to("cuda")
        base = chip_smoke.pair_step_inputs(batch, torch.Generator(device="cuda").manual_seed(6))
        idx = (batch.receivers, batch.senders, chip_smoke.pair_aux(batch), batch.n_graphs,
               batch.tile)
        step = lambda args: fused_edge.fused_edge_step2(*args, *idx)  # noqa: E731
    else:
        batch = pack_batch(chip_smoke.build_request(0), reorder="rcm", sender_view=False,
                           div_ell=False).to("cuda")
        gen = torch.Generator(device="cuda")
        aux = (batch.receivers, (batch.edge_gid, batch.edge_block_tile), batch.n_graphs,
               batch.tile)
        if kernel == "fused_edge3_fwd":
            base = chip_smoke.edge_step_inputs(batch, gen.manual_seed(0))
            step = lambda args: fused_edge3.fused_edge_step3(*args, *aux)  # noqa: E731
        else:
            base = chip_smoke.v2_step_inputs(batch, gen.manual_seed(3))
            step = lambda args: fused_edge.fused_edge_step(*args, *aux)  # noqa: E731
    for sd_name, sd in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        args = [base[k].to(sd).contiguous() for k in base]
        yield sd_name, lambda args=args: step(args)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", default="fused_edge3_fwd", choices=tuple(SUBS))
    kernel = ap.parse_args().kernel
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    variants = VARIANTS if kernel == "fused_edge3_fwd" else V2_VARIANTS
    defines = build_variants(kernel, variants, EXTRA)
    subs = SUBS[kernel]
    cases = list(calls(kernel))
    for name, d in defines.items():
        with variant(kernel, d):
            for sd_name, call in cases:
                if name == "part clock":
                    print(f"{name} {sd_name}: "
                          f"{part_times(cuda_build.library(kernel), kernel, call)}", flush=True)
                    continue
                for _ in range(2):
                    call()
                torch.cuda.synchronize()
                with torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                    for _ in range(5):
                        call()
                    torch.cuda.synchronize()
                times = {sub: 0.0 for sub in subs}
                for e in prof.key_averages():
                    for sub in subs:
                        if sub in e.key:
                            times[sub] += e.device_time_total / 5e3
                print(f"{name} {sd_name}: "
                      + " ".join(f"{k} {v:.3f}" for k, v in times.items() if v)
                      + f" ms; sum {sum(times.values()):.3f} ms", flush=True)


if __name__ == "__main__":
    main()
