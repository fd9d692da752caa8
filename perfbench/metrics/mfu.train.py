"""% of the traced window that the model's FLOPs of its training steps
(forward, and twice that for the backward; remat's recompute not counted)
need at the peaks of their precisions."""

from perfbench.harness.yardstick import mfu


def read(run):
    return mfu(run) if run.unit == "step" else None
