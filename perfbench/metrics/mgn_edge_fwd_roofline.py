"""% of the least time of MeshGraphNets' edge update forward's launches
(``kernels/mgn_edge_fwd.json``) in their measured device time, over a
training step's launches: the mean least time of the window's launches over
their mean device time, as ``yardstick.roofline`` takes it, with the
operations rated as the kernel runs them: six bf16 products on the tensor
cores for each fp32 product (bf16x6), at a sixth of the bf16 peak. At the
cell's sizes the bytes set the bound. The cell's configuration names only
#3 among its kernels, so the reader takes this kernel's file itself; a
trace without the kernel's launches, as a program without the kernel
gives, reads None."""

from dataclasses import replace

from perfbench.harness import registry
from perfbench.harness.yardstick import (
    HBM_BYTES_PER_S,
    PEAK_FLOPS,
    STREAM_BYTES,
    evaluate,
    kernel_launches,
)

KERNEL = "mgn_edge_fwd"
SPLIT = 6  # bf16 products per fp32 product


def least_time(spec: dict, unit: dict, cfg: dict) -> float:
    sizes = dict(L=cfg["latent_size"], E=unit["E"], N=unit["N"],
                 s=STREAM_BYTES[cfg["stream_dtype"]])
    return max(evaluate(spec["flops"], **sizes) * SPLIT / PEAK_FLOPS["bfloat16"],
               evaluate(spec["bytes"], **sizes) / HBM_BYTES_PER_S)


def read(run):
    if run.unit != "step" or not run.units:
        return None
    run = replace(run, kernels={**run.kernels, **registry.kernels([KERNEL])})
    launches, seconds = kernel_launches(run, KERNEL)
    if not launches or seconds <= 0:
        return None
    need = sum(least_time(run.kernels[KERNEL], u, run.cfg) for u in run.units)
    return 100.0 * need * launches / len(run.units) / seconds
