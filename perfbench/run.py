"""Run one cell of the benchmark of the PyTorch/CUDA port once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``configs/<config>.json``, whose ``arch`` names ``arch/<arch>.py``) and
a traffic mix (``traffic/<mix>.json``, whose ``kind`` names its driver
``harness/<kind>.py``). The run makes its inputs and weights from the seed, builds and warms the
program (``p_div_gnn_tpu_torch``) on the card, then measures for
``--seconds`` (``--trace 0``: the cell's end-to-end metrics) or traces a
short window (``--trace 1``: its per-layer metrics, read by
``metrics/<metric>.py``), checks the outputs against the plain reference
(``reference/``), and prints one JSON line last. Without a CUDA card it
exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the checkout's root on the path, in place of this folder
sys.path[0] = str(Path(__file__).resolve().parents[1])

from perfbench.harness import common, registry  # noqa: E402


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    common.set_cache_dirs()
    work = registry.cell(args.workload)
    traffic = registry.traffic(work["traffic"])

    from perfbench.inputs.pool import PoolBuilder

    # the pool is read from the checkout's cache, or built in worker
    # processes while torch and the card start
    pool = PoolBuilder(traffic["pool"], cache=common.CACHE / "pool")
    try:
        cfg = registry.config(work)
        common.require_cards(work["chips"])

        import torch

        from perfbench.harness.compare import judged, limits
        from perfbench.harness.trace import breakdown
        from perfbench.harness.yardstick import Run

        driver = registry.driver(traffic["kind"])
        out = driver.run(cfg, traffic, args.seed, args.seconds, bool(args.trace), "cuda",
                         T_START, pool=pool)
    finally:
        pool.close()
    found = common.forbidden_loaded()
    if found:
        print(f"perfbench: JAX modules were loaded: {', '.join(found)}", file=sys.stderr)
        return 3

    metrics: dict = {}
    result: dict = {}
    if args.trace:
        run = Run(cfg=cfg, unit=driver.UNIT, units=out["units"], trace=out["trace"],
                  kernels=registry.kernels(cfg["kernels"]), spans=out["spans"])
        for m in work["per_layer"]:
            value = registry.metric_reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = breakdown(out["trace"])
    else:
        for m in work["end_to_end"]:
            metrics[m["name"]] = {"value": out[m["name"]], "unit": m["unit"]}
    correct, checks = judged(out["numbers"], limits(args.workload))
    correct = correct and out["failed"] == 0
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": work["chips"],
              "memory_peak_bytes": int(out["memory_peak_bytes"])}
    if args.trace:
        device.update(busy_s=out["trace"].busy_s, window_s=out["trace"].window_s)
    print(f"perfbench: {common.power_limit()}; {args.workload} seed {args.seed}: "
          f"{out['attempted']} attempted, {out['failed']} failed "
          f"{' '.join(out.get('errors', []))}", file=sys.stderr)
    common.emit({"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
                 "metrics": metrics, "device": device, **result}, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
