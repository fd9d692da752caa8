"""% of the traced serving window in which no kernel, copy or set ran on
the device."""

from perfbench.harness.yardstick import idle_share


def read(run):
    return idle_share(run) if run.unit == "request" else None
