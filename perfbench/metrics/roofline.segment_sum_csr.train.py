"""% of the least time of #3's launches (its shapes over the card's peaks,
``kernels/segment_sum_csr.json``) in their measured device time, over a
training step's launches."""

from perfbench.harness.yardstick import roofline


def read(run):
    return roofline(run, "segment_sum_csr") if run.unit == "step" else None
