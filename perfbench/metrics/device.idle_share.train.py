"""% of the traced training window in which no kernel, copy or set ran on
the device."""

from perfbench.harness.yardstick import idle_share


def read(run):
    return idle_share(run) if run.unit == "step" else None
