"""Find what a cell names, by name: the cell and its metrics in
``BENCHMARK.json``, its configuration (``configs/<config>.json``) and the
module of the architecture the configuration names (``arch/<arch>.py``),
its traffic mix (``traffic/<traffic>.json``) and the driver of the mix's
kind (``harness/<kind>.py``), the per-layer metric readers
(``metrics/<metric>.py``) and the port kernels' descriptions
(``kernels/<kernel>.json``). Adding any of them is adding a file."""

from __future__ import annotations

import importlib
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
    """The configuration file's contents, with every key that its
    architecture's module requires."""
    path = Path(work["config_file"])
    cfg = json.loads(path.read_text())
    if "arch" not in cfg:
        raise SystemExit(f"{path}: no \"arch\" key; it names the configuration's module "
                         f"{BENCH / 'arch'}/<arch>.py")
    missing = [k for k in arch(cfg["arch"]).REQUIRED_KEYS if k not in cfg]
    if missing:
        raise SystemExit(f"{path}: lacks {', '.join(missing)}, which arch/{cfg['arch']}.py "
                         "requires")
    return cfg


def _module(package: str, folder: Path, name: str, what: str) -> ModuleType:
    path = folder / f"{name}.py"
    if not name.isidentifier() or not path.is_file():
        raise SystemExit(f"no {what} {name!r}: {path} is not there")
    return importlib.import_module(f"{package}.{name}")


def arch(name: str) -> ModuleType:
    """The module of ``arch/<name>.py``: what the training driver and the
    yardstick know of one architecture (its docstring gives the contract)."""
    return _module("perfbench.arch", BENCH / "arch", name, "architecture")


def driver(kind: str) -> ModuleType:
    """The module of ``harness/<kind>.py``, the driver of a traffic kind:
    its ``run(cfg, traffic, seed, seconds, trace, device, t_start, pool=)``
    runs a cell once, ``UNIT`` names what its traced units are ("step" or
    "request"), and ``calibration_rows`` reads the numbers that set a
    cell's limits (``calibrate.py``)."""
    return _module("perfbench.harness", BENCH / "harness", kind, "traffic kind")


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
