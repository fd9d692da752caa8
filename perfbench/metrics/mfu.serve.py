"""% of the traced window that the model's forward FLOPs of its served
requests need at the peaks of their precisions."""

from perfbench.harness.yardstick import mfu


def read(run):
    return mfu(run) if run.unit == "request" else None
