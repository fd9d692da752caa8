"""Where the time of one training step of the port goes on the card.

    PYTHONPATH=. python scripts/port_profile_step.py
        [--impl fused3|fused|fused2|hybrid|pallas|xla] [--stream-dtype float32|bfloat16]
        [--loader] [--trace build/step_trace.json]

Builds ``chip_smoke.py``'s training batch (pair-blocked for fused2; with
``--loader`` the same 16 meshes packed as ``GraphLoader`` packs them, at
its bucketed capacities) and model (the benchmark's step:
latent 128, 10 message-passing steps, no remat, NMSE + 10 x divergence,
Adam), takes two warm-up ``Trainer.train_step``s, then traces a third with
``torch.profiler`` (CPU and CUDA activity). It prints the step's wall time,
the device time of each kernel group (the port's kernels, each with its
launches and sub-kernels, then the rest by name), the device's busy time
(the union of all kernel, copy and set intervals) and its idle share over
the step's window (from the step's start on the host to the end of its last
device interval). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from p_div_gnn_tpu_torch.datagen.workload import build_samples, build_workload  # noqa: E402
from p_div_gnn_tpu_torch.models.epd import SCATTER_IMPLS  # noqa: E402
from p_div_gnn_tpu_torch.train.data import GraphLoader  # noqa: E402

# sub-kernel names of each ported kernel's library (csrc/*.cu), its own tile
# kernels first; the three backwards share the others (csrc/bwd_common.cuh)
# and the three forwards theirs (csrc/fwd_common.cuh), which go to the
# kernel whose tile kernel ran in the step
_BWD_SHARED = ("prepare_weights_kernel", "bwd_wgrad_kernel", "bwd_reduce_kernel")
GROUPS = {
    "fused_edge3_fwd (#1)": ("step3_fwd_fma_kernel", "step3_fwd_mma_kernel",
                             "copy_weights_kernel", "moments_reduce_kernel"),
    "fused_edge3_bwd (#2)": ("step3_bwd_tile_kernel",) + _BWD_SHARED,
    # #3 and #4 run the same two kernels; a step runs one of them (#3:
    # fused3, pallas, hybrid; #4: fused, fused2)
    "segment_sum_csr (#3) / segment_sum_csr_pair (#4)": ("run_chunk_kernel",
                                                          "run_merge_kernel"),
    "fused_edge_fwd (#5)": ("v2_fwd_tile_fma_kernel", "v2_fwd_tile_mma_kernel",
                            "copy_weights_kernel", "moments_reduce_kernel"),
    "fused_edge_bwd (#6)": ("v2_bwd_tile_kernel",) + _BWD_SHARED,
    "fused_edge2_fwd (#7)": ("pair_fwd_tile_fma_kernel", "pair_fwd_tile_mma_kernel",
                             "zero_z_rows_kernel", "copy_weights_kernel",
                             "moments_reduce_kernel"),
    "fused_edge2_bwd (#8)": ("pair_bwd_tile_kernel", "zero_rows_kernel") + _BWD_SHARED,
}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def group_of(name: str, ran: set[str]) -> str | None:
    for group, subs in GROUPS.items():
        if group in ran and any(sub in name for sub in subs):
            return group
    return None


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--impl", default="fused3", choices=SCATTER_IMPLS)
    ap.add_argument("--stream-dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--loader", action="store_true",
                    help="pack the meshes at GraphLoader's bucketed capacities")
    ap.add_argument("--trace", default=None, help="also write the chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)

    pair = args.impl == "fused2"
    if args.loader:
        samples = build_samples(chip_smoke.N_MESHES, seed=0)
        loader = GraphLoader(samples, len(samples), pair_blocks=pair, device="cuda")
        host, n_edges = loader._pack(range(len(samples))), sum(s.num_edges for s in samples)
    else:
        host, n_edges, _ = build_workload(chip_smoke.N_MESHES, seed=0, pair_blocks=pair)
    print(f"batch: Np={host.num_nodes_padded} Ep={host.num_edges_padded}"
          + (" (GraphLoader's capacities)" if args.loader else ""), flush=True)
    batch = host.to("cuda")
    trainer = chip_smoke.make_trainer(args.impl, args.stream_dtype, "cuda")
    for _ in range(2):
        trainer.train_step(batch)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with torch.profiler.record_function("train_step"):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(args.trace) if args.trace else Path(tmp) / "trace.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]

    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    step = next(e for e in events
                if e.get("name") == "train_step" and e.get("cat") == "user_annotation")
    if not dev:
        raise SystemExit("the profiler recorded no device activity")
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev)
    busy, cur_lo, cur_hi = 0.0, *spans[0]
    for lo, hi in spans[1:]:
        if lo > cur_hi:
            busy += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    busy += cur_hi - cur_lo
    window = max(float(step["ts"]) + float(step["dur"]), spans[-1][1]) - float(step["ts"])

    # a group ran if one of its own sub-kernels (not shared with another
    # group) did
    shared = {s for g, subs in GROUPS.items() for s in subs
              if any(s in other for h, others in GROUPS.items() if h != g for other in others)}
    ran = {g for g, subs in GROUPS.items()
           if any(s in e["name"] for s in subs if s not in shared for e in dev)}
    by_group: dict[str, list[float]] = defaultdict(lambda: [0.0, 0])
    by_sub: dict[str, list[float]] = defaultdict(lambda: [0.0, 0])
    rest: dict[str, list[float]] = defaultdict(lambda: [0.0, 0])
    for e in dev:
        name, dur = e["name"], float(e["dur"]) / 1e3
        g = group_of(name, ran)
        if g is None:
            rest[name][0] += dur
            rest[name][1] += 1
            continue
        by_group[g][0] += dur
        by_group[g][1] += 1
        sub = next(s for s in GROUPS[g] if s in name)
        by_sub[sub][0] += dur
        by_sub[sub][1] += 1

    total_dev = sum(float(e["dur"]) for e in dev) / 1e3
    print(f"train step {args.impl} {args.stream_dtype}: wall {wall_ms:.3f} ms, "
          f"{n_edges / wall_ms * 1e3:.0f} edges/s; device busy {busy / 1e3:.3f} ms of a "
          f"{window / 1e3:.3f} ms window, idle share {1 - busy / window:.4f}; "
          f"sum of device intervals {total_dev:.3f} ms; peak memory allocated {peak_gb:.2f} GB",
          flush=True)
    for g, (ms, n) in sorted(by_group.items(), key=lambda kv: -kv[1][0]):
        print(f"  {g}: {ms:.3f} ms over {n} device kernels ({ms / total_dev:.1%} of device time)")
    for sub, (ms, n) in sorted(by_sub.items(), key=lambda kv: -kv[1][0]):
        print(f"    {sub}: {ms:.3f} ms over {n} device kernels")
    rest_ms = sum(v[0] for v in rest.values())
    print(f"  rest: {rest_ms:.3f} ms over {sum(v[1] for v in rest.values())} device "
          f"intervals ({rest_ms / total_dev:.1%}); largest:")
    for name, (ms, n) in sorted(rest.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"    {ms:8.3f} ms {n:5d}x {name[:110]}")


if __name__ == "__main__":
    main()
