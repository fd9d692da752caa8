"""% of the least time of #1's launches (its shapes over the card's peaks,
``kernels/fused_edge3_fwd.json``) in their measured device time, over a
training step's launches."""

from perfbench.harness.yardstick import roofline


def read(run):
    return roofline(run, "fused_edge3_fwd") if run.unit == "step" else None
