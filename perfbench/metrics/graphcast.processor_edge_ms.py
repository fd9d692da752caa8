"""Device ms per training step in GraphCast's processor edge updates: the
program's ``graphcast.edge`` spans (one a multimesh step, in the forward)
summed, between their CUDA events."""

from perfbench.harness.program import phase_ms


def read(run):
    return phase_ms(run, "graphcast.edge")
