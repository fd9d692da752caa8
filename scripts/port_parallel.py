"""Run ``chip_smoke.py``'s ``parallel`` phase alone: data-parallel and
edge-partitioned training of the port at full width over spawned ranks,
each held against the single-process step, the committed checkpoint's
partitioned forward, and the weak-scaling rows (``chip_smoke.py::
parallel_phase``). From the repo root, on a machine with a CUDA card and
nvcc:

    python3 scripts/port_parallel.py [--wide-only]

With ``--wide-only`` it runs only the committed checkpoint's partitioned
forward at D = 4 (``chip_smoke.py::wide_forward_phase``, which needs four
cards) against the single-process forward. It builds the kernels of the fused3 and fused paths first (nvcc, in
parallel), then draws the benchmark's 16 meshes (seed 0) and packs them as
``chip_smoke.py`` does. It imports nothing of JAX. Exits 1 on any failed
check.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    import chip_smoke
    from p_div_gnn_tpu_torch.datagen.workload import build_samples, pack_workload
    from p_div_gnn_tpu_torch.ops import cuda_build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    cuda_build.libraries("fused_edge3_fwd", "fused_edge3_bwd", "segment_sum_csr",
                         "fused_edge_fwd", "fused_edge_bwd")
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    samples = build_samples(chip_smoke.N_MESHES, seed=0)
    host_train = pack_workload(samples)[0]
    try:
        if "--wide-only" in sys.argv[1:]:
            train_batch = host_train.to("cuda")
            failed, launches = chip_smoke.wide_forward_phase(
                host_train, train_batch, chip_smoke.served_forward(train_batch))
            print(f"parallel D={chip_smoke.WIDE_RANKS}: launches {launches}", flush=True)
            chip_smoke.check(not failed, "; ".join(failed))
            return 0
        chip_smoke.parallel_phase(samples, host_train, host_train.to("cuda"), smi)
    except chip_smoke.SmokeFailure as exc:
        print(f"port_parallel: FAILED: {exc}", file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
