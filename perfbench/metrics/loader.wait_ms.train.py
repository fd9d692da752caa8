"""Host ms per training step that the step waited for its batch from
``prefetch``: the program's ``loader.wait`` spans (loader layer)."""

from perfbench.harness.program import host_ms


def read(run):
    return host_ms(run, "loader.wait")
