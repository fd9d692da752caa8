"""Everything ``BENCHMARK.json`` names is found by name and parses, and the
file keeps to the benchmark's contract."""

import json
import re

import pytest

from perfbench.harness import registry

BENCH = registry.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
# what every architecture module offers (the contract in arch/pdivgnn.py's docstring)
ARCH_CONTRACT = ("REQUIRED_KEYS", "draw_inputs", "port_samples", "draw_weights", "build_program",
                 "reference_stats", "reference_batch", "reference_loss", "model_flops",
                 "fault_sites")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_and_units():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(conf):
    data = json.loads((registry.ROOT / conf["file"]).read_text())
    assert data["name"] == conf["name"]
    assert conf["file"].startswith("perfbench/")
    assert data["reduced"] == conf["reduced"]
    assert all(key in data for key in registry.arch(data["arch"]).REQUIRED_KEYS)
    if "checkpoint" in data:
        assert (registry.ROOT / data["checkpoint"]).is_file()
    assert list(registry.kernels(data["kernels"])) == data["kernels"]  # those files alone


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_found_by_name(cell):
    work = registry.cell(cell)
    traffic = registry.traffic(work["traffic"])
    driver = registry.driver(traffic["kind"])
    assert callable(driver.run) and driver.UNIT in ("step", "request")
    e2e = {m["name"] for m in work["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2 and work["per_layer"]
    assert all(m["moves"] in e2e for m in work["per_layer"])
    numbers = json.loads((registry.BENCH / "limits" / f"{cell}.json").read_text())["numbers"]
    assert numbers and all("limit" in v for v in numbers.values())


@pytest.mark.parametrize("arch", sorted(p.stem for p in (registry.BENCH / "arch").glob("*.py")
                                         if p.stem != "__init__"))
def test_arch_module_keeps_the_contract(arch):
    module = registry.arch(arch)
    assert all(hasattr(module, name) for name in ARCH_CONTRACT)
    assert {"latent_size", "batch_size", "learning_rate", "stream_dtype"} <= set(
        module.REQUIRED_KEYS)  # read by the training driver and the yardstick


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader(metric):
    module = registry.metric_reader(metric["name"])
    assert callable(module.read)
    if metric["name"].startswith("roofline."):  # each of its cells' configurations names it
        for cell in metric.get("workloads", CELLS):
            cfg = registry.config(registry.cell(cell))
            assert metric["name"].split(".")[1] in cfg["kernels"]


def test_layers_are_named_alike():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


@pytest.mark.parametrize("kernel", sorted(registry.kernels()))
def test_kernel_file(kernel):
    spec = registry.kernels()[kernel]
    assert set(spec["launch"]) <= set(spec["own"])
    assert spec["peak"] in ("stream", "float32")
    from perfbench.harness.yardstick import evaluate

    assert evaluate(spec["flops"], L=128, E=10, N=5, s=4) > 0
    assert evaluate(spec["bytes"], L=128, E=10, N=5, s=4) > 0
