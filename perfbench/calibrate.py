"""Read the numbers that set a cell's limits, on the card, in one process:
for each seed, the program's sound run, the control (the reference in the
nearest precision below the configuration's, put in the program's place)
and, for a training cell, each planted fault, all against the reference.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1 2 3 ... [--controls 3]
        [--faults 3] [--out chiprun_out/calibrate_<cell>.jsonl]
    python3 perfbench/calibrate.py --workload <cell> --derive <readings.jsonl> ...

Each traffic kind's driver (``harness/<kind>.py``) reads its own rows
(``calibration_rows``): training the first three steps; serving runs its
clients for ``--seconds`` at the cell's load and compares the window's
sampled requests. One JSON line per (seed, kind) goes to ``--out`` and stdout.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parents[1])

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

from perfbench.harness import common, registry  # noqa: E402

def derive(rows: list[dict], names: list[str]) -> dict:
    """Each number's limit from its readings: the lower reading is the
    largest of the program's sound runs; the upper the control's smallest
    where that is three times the lower or more, or the smallest of a
    fault's readings where all of that fault's are ten times the lower or
    more (a state left unchanged: three times); the limit lies between
    them with more room above the lower (lower^0.4 · upper^0.6)."""
    out = {}
    for name in names:
        lower = max(r[name] for r in rows if r["kind"] == "program")
        candidates = {}
        for kind in {r["kind"] for r in rows} - {"program"}:
            least = min(r[name] for r in rows if r["kind"] == kind)
            factor = 3 if kind in ("control", "state_unchanged") else 10
            if least >= factor * lower:
                candidates[kind] = least
        entry = {"lower": lower, "upper": None, "upper_from": None, "limit": None,
                 "readings": {kind: sorted(r[name] for r in rows if r["kind"] == kind)
                              for kind in sorted({r["kind"] for r in rows})}}
        if candidates:
            kind = min(candidates, key=candidates.get)
            upper = candidates[kind]
            entry.update(upper=upper, upper_from=kind,
                         limit=float(f"{lower ** 0.4 * upper ** 0.6:.2g}"))
        out[name] = entry
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[])
    ap.add_argument("--derive", nargs="+", default=None,
                    help="readings (JSON lines) to set the cell's limits from")
    ap.add_argument("--controls", type=int, default=3, help="seeds that also read the control")
    ap.add_argument("--faults", type=int, default=3, help="seeds that also read the faults")
    ap.add_argument("--seconds", type=float, default=4.0, help="serving: the clients' window")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.derive:
        rows = [json.loads(line) for path in args.derive for line in Path(path).read_text().splitlines()]
        rows = [r for r in rows if r["cell"] == args.workload]
        path = registry.BENCH / "limits" / f"{args.workload}.json"
        names = list(json.loads(path.read_text())["numbers"])
        numbers = derive(rows, names)
        path.write_text(json.dumps({"cell": args.workload, "numbers": numbers}, indent=1) + "\n")
        print(json.dumps(numbers, indent=1))
        return 0
    common.set_cache_dirs()
    work = registry.cell(args.workload)
    cfg, traffic = registry.config(work), registry.traffic(work["traffic"])
    driver = registry.driver(traffic["kind"])
    common.require_cards(work["chips"])
    out = Path(args.out or f"chiprun_out/calibrate_{args.workload}.jsonl")
    out.parent.mkdir(parents=True, exist_ok=True)
    print(common.power_limit(), flush=True)
    with out.open("a") as fh:
        for i, seed in enumerate(args.seeds):
            t0 = time.perf_counter()
            rows = driver.calibration_rows(cfg, traffic, seed, args.seconds, i < args.controls,
                                           i < args.faults)
            for kind, numbers in rows:
                line = json.dumps({"cell": args.workload, "seed": seed, "kind": kind, **numbers,
                                   "seconds": time.perf_counter() - t0})
                print(line, flush=True)
                fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
