"""Each traffic mix's loop at a tiny size on the CPU, through the port's
plain paths, against the reference; the lower-precision control and the
planted faults read as not correct; a run without a card prints nothing."""

import json
import subprocess
import sys
import time

import pytest
import torch

from perfbench.harness import registry, serve, train
from perfbench.harness.compare import judged, limits, train_numbers
from perfbench.harness.faults import FAULTS, planted
from perfbench.inputs.pool import build_pool

SEED = 2**31 + 11
# mixes with limits but no cell of BENCHMARK.json yet: (configuration, traffic, per-layer metrics)
KEPT = {
    "train.bf16": ("pdivgnn-bf16", "train-loader", []),
    "serve.fp32": ("pdivgnn-fp32", "serve-closed",
                   ["serve.p95_ms", "serve.pack_ms", "roofline.fused_edge3_fwd.serve",
                    "mfu.serve", "device.idle_share.serve"]),
}


def files(cell: str) -> tuple[dict, dict, list[str]]:
    """(configuration, traffic, per-layer metric names) of a cell."""
    if cell in KEPT:
        config, mix, names = KEPT[cell]
        cfg = registry.config({"config_file": registry.BENCH / "configs" / f"{config}.json"})
        return cfg, registry.traffic(mix), names
    work = registry.cell(cell)
    return (registry.config(work), registry.traffic(work["traffic"]),
            [m["name"] for m in work["per_layer"]])


def tiny(cell: str) -> tuple[dict, dict]:
    cfg, traffic, _ = files(cell)
    if traffic["kind"] == "train":  # serving keeps the checkpoint's widths
        cfg.update(latent_size=16, message_passing_steps=2, batch_size=2)
    traffic["pool"] = dict(traffic["pool"], meshes=6, global_mesh_refinement_size=12.0,
                           hole_refinement_factor=2.0)
    traffic.update(request_meshes=3, warmup_steps=1, trace_steps=2, trace_requests=2)
    return cfg, traffic


def run_cell(cell: str, trace: bool = False, seed: int = SEED) -> dict:
    cfg, traffic = tiny(cell)
    return registry.driver(traffic["kind"]).run(cfg, traffic, seed, 1.0, trace, "cpu", time.perf_counter(), workers=1)


@pytest.mark.parametrize("cell", ["train.fp32", "train.bf16", "serve.fp32"])
def test_loop_agrees_with_the_reference(cell):
    out = run_cell(cell)
    correct, checks = judged(out["numbers"], limits(cell))
    assert correct, checks
    assert out["attempted"] > 0 and out["failed"] == 0
    kind = files(cell)[1]["kind"]
    wanted = "train_edges_per_s" if kind == "train" else "serve_meshes_per_s"
    assert out[wanted] > 0 and out["setup_s"] > 0


@pytest.mark.parametrize("cell", ["train.fp32", "serve.fp32"])
def test_traced_run_reads_its_layer_metrics(cell):
    out = run_cell(cell, trace=True)
    from perfbench.harness.yardstick import Run

    cfg, traffic, names = files(cell)
    run = Run(cfg=tiny(cell)[0], unit=registry.driver(traffic["kind"]).UNIT, units=out["units"],
              trace=out["trace"], kernels=registry.kernels(cfg["kernels"]), spans=out["spans"])
    assert out["units"] and run.trace.window_s > 0
    values = {name: registry.metric_reader(name).read(run) for name in names}
    kind = traffic["kind"]
    # the CPU trace has no device intervals: only the host's readings remain
    if kind == "train":
        assert 0 < values["loader.padding_share.train"] < 100
    else:
        assert values["serve.pack_ms"] > 0


@pytest.mark.parametrize("fault", FAULTS)
def test_faults_come_out_not_correct(fault):
    cell = "serve.fp32" if fault == "answer_altered" else "train.fp32"
    with planted(fault, "pdivgnn"):
        out = run_cell(cell, seed=SEED + 1)
    correct, checks = judged(out["numbers"], limits(cell))
    assert not correct, checks


def test_answer_altered_fails_training_too():
    with planted("answer_altered", "pdivgnn"):
        out = run_cell("train.fp32", seed=SEED + 2)
    assert not judged(out["numbers"], limits("train.fp32"))[0]


def test_bf16_control_comes_out_not_correct():
    """The control of the bf16 streams: the reference with its streams in
    fp8, in the program's place."""
    cfg, traffic = tiny("train.bf16")
    cfg["message_passing_steps"] = 10
    inputs = train.make_inputs(cfg, traffic, SEED, workers=1)
    ref = train.reference_first_steps(cfg, inputs, "cpu", stream=torch.bfloat16)
    low = train.reference_first_steps(cfg, inputs, "cpu",
                                      stream=torch.float8_e4m3fn)
    assert not judged(train_numbers(low, ref), limits("train.bf16"))[0]


def test_run_without_a_card_prints_no_result():
    proc = subprocess.run(
        [sys.executable, str(registry.BENCH / "run.py"), "--workload", "train.fp32", "--seed",
         str(SEED), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=registry.ROOT)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible here")
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


@pytest.mark.card
@pytest.mark.parametrize("cell", ["train.fp32", "serve.fp32"])
def test_tf32_control_comes_out_not_correct_on_the_card(cell):
    """The control of the fp32 configuration: the reference in fp32 with
    TF32 on, in the program's place, at the cell's own size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg, traffic, _ = files(cell)
    if traffic["kind"] == "train":
        inputs = train.make_inputs(cfg, traffic, SEED)
        ref = train.reference_first_steps(cfg, inputs, "cuda")
        low = train.reference_first_steps(cfg, inputs, "cuda", dtype=torch.float32,
                                          tf32=True)
        numbers = train_numbers(low, ref)
    else:
        from perfbench.harness.compare import serve_numbers
        from perfbench.reference.ckpt import read_checkpoint

        pool = build_pool(traffic["pool"])
        _, stats = read_checkpoint(registry.ROOT / cfg["checkpoint"])
        ids, means = serve.request(len(pool), traffic["request_meshes"], stats, SEED, 0, 0)
        req = {"ids": ids, "means": means}
        ref = serve.reference_fields(cfg, pool, req, "cuda")
        low = serve.reference_fields(cfg, pool, req, "cuda", dtype=torch.float32, tf32=True)
        numbers = serve_numbers([x.cpu().numpy() for x in low], ref, stats["std_local_stress"])
    assert not judged(numbers, limits(cell))[0], numbers
