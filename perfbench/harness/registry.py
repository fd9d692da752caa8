"""Find what a cell names, by name: the cell and its metrics in
``BENCHMARK.json``, its configuration (``configs/<config>.json``), its
traffic mix (``traffic/<traffic>.json``), the per-layer metric readers
(``metrics/<metric>.py``) and the port kernels' descriptions
(``kernels/<kernel>.json``). Adding any of them is adding a file."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(name: str) -> dict:
    """The workload entry with its end-to-end and per-layer metrics."""
    bench = benchmark()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")
    work = dict(found[0])

    def applies(metric: dict) -> bool:
        return name in metric.get("workloads", [name])

    work["end_to_end"] = [m for m in bench["end_to_end"] if applies(m)]
    e2e = {m["name"] for m in work["end_to_end"]}
    work["per_layer"] = [m for m in bench["per_layer"]
                         if applies(m) and ("workloads" in m or m["moves"] in e2e)]
    conf = next(c for c in bench["configs"] if c["name"] == work["config"])
    work["config_file"] = ROOT / conf["file"]
    return work


def config(work: dict) -> dict:
    return json.loads(Path(work["config_file"]).read_text())


def traffic(name: str) -> dict:
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def kernels(names: list[str] | None = None) -> dict[str, dict]:
    """The descriptions of the named port kernels (a configuration's
    ``kernels``: those its path runs), or of every one, by name. A kernel
    file that a configuration does not name changes none of its metrics."""
    if names is None:
        names = sorted(p.stem for p in (BENCH / "kernels").glob("*.json"))
    return {n: json.loads((BENCH / "kernels" / f"{n}.json").read_text()) for n in names}


def metric_reader(name: str) -> ModuleType:
    """The module of ``metrics/<name>.py``; its ``read(run)`` gives the
    metric's value, or None where the run has nothing to read."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("perfbench_metric_" + name.replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
