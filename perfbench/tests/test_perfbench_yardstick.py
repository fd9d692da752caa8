"""The roofline, MFU and trace arithmetic against hand counts."""

import pytest

from perfbench.harness import registry
from perfbench.harness.trace import Trace, gap_labels, idle_gaps, merge
from perfbench.harness.yardstick import (
    HBM_BYTES_PER_S,
    PEAK_FLOPS,
    Run,
    idle_share,
    mfu,
    model_flops,
    rest_seconds,
    roofline,
)

CFG = {"arch": "pdivgnn", "latent_size": 4, "message_passing_steps": 2, "stream_dtype": "float32"}


def fake_trace() -> Trace:
    dev = [  # (name, cat, start us, duration us)
        ("void step3_fwd_fma_kernel<float, 128>(FwdArgs)", "kernel", 0.0, 1.0),
        ("copy_weights_kernel", "kernel", 1.0, 0.5),
        ("void step3_fwd_fma_kernel<float, 128>(FwdArgs)", "kernel", 2.0, 1.0),
        ("copy_weights_kernel", "kernel", 3.0, 0.5),
        ("elementwise_kernel", "kernel", 5.0, 2.0),
        ("Memset (Device)", "gpu_memset", 9.0, 1.0),
    ]
    host = [("train_step", "span", -1.0, 12.0), ("cudaStreamSynchronize", "cuda_runtime", 3.4, 2.0)]
    t = Trace(device=dev, host=host, start_us=0.0, end_us=10.0)
    t.merged = merge([(s, s + d) for _, _, s, d in dev])
    return t


def test_roofline_hand_count():
    run = Run(cfg=CFG, unit="step", units=[{"E": 10, "N": 5}], trace=fake_trace(),
              kernels=registry.kernels())
    flops = 2 * 16 * (5 * 10 + 2 * 5)
    n_bytes = 4 * (5 * 4 + 2 * 10 * 4 + 4 * 16 + 2 * 4) + 4 * 2 * 10 + 4 * 10 * 4 + 4 * (5 * 4 + 32)
    assert (flops, n_bytes) == (1920, 1136)
    least = max(flops / PEAK_FLOPS["float32"], n_bytes / HBM_BYTES_PER_S)
    # two launches, each 1 us of tile and 0.5 us of shared weight copy
    assert roofline(run, "fused_edge3_fwd") == pytest.approx(100 * 2 * least / 3e-6)
    assert roofline(run, "fused_edge3_bwd") is None


def test_mfu_hand_count():
    stream, other = model_flops(CFG, 10, 5)
    assert (stream, other) == (2 * 2 * 16 * 60, 400 + 400 + 960 + 280)
    run = Run(cfg=CFG, unit="step", units=[{"E": 10, "N": 5}], trace=fake_trace(),
              kernels=registry.kernels())
    assert mfu(run) == pytest.approx(100 * 3 * (stream + other) / 67e12 / 10e-6)
    bf16 = dict(CFG, stream_dtype="bfloat16")
    run = Run(cfg=bf16, unit="request", units=[{"E": 10, "N": 5}], trace=fake_trace(),
              kernels=registry.kernels())
    assert mfu(run) == pytest.approx(100 * (stream / 989e12 + other / 67e12) / 10e-6)


def test_busy_idle_and_rest():
    t = fake_trace()
    assert t.merged == [(0.0, 1.5), (2.0, 3.5), (5.0, 7.0), (9.0, 10.0)]
    assert t.busy_s == pytest.approx(6e-6)
    assert idle_gaps(t) == [(1.5, 2.0), (3.5, 5.0), (7.0, 9.0)]
    run = Run(cfg=CFG, unit="step", units=[{"E": 10, "N": 5}], trace=t,
              kernels=registry.kernels())
    assert idle_share(run) == pytest.approx(40.0)
    assert rest_seconds(run) == pytest.approx(3e-6)
    labels = gap_labels(t)
    assert labels["train_step / cudaStreamSynchronize"] == pytest.approx(1.5e-6)
    assert labels["train_step / host code"] == pytest.approx(2.5e-6)


@pytest.mark.parametrize("name", ["step.launches.train", "loader.padding_share.train",
                                  "step.rest_ms.train", "device.idle_share.train"])
def test_readers_on_a_step(name):
    run = Run(cfg=CFG, unit="step", units=[{"E": 10, "N": 5, "slots": 40}], trace=fake_trace(),
              kernels=registry.kernels())
    want = {"step.launches.train": 5, "loader.padding_share.train": 75.0,
            "step.rest_ms.train": 3e-3, "device.idle_share.train": 40.0}[name]
    assert registry.metric_reader(name).read(run) == pytest.approx(want)


def test_readers_find_nothing_elsewhere():
    run = Run(cfg=CFG, unit="request", units=[{"E": 10, "N": 5}], trace=fake_trace(),
              kernels=registry.kernels())
    assert registry.metric_reader("loader.padding_share.train").read(run) is None
    assert registry.metric_reader("serve.pack_ms").read(run) is None
    run.spans["pack_batch"] = [0.010, 0.030]
    assert registry.metric_reader("serve.pack_ms").read(run) == pytest.approx(20.0)
