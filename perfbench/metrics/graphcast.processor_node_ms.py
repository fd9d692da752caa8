"""Device ms per training step in GraphCast's processor node updates, the
sum over the receivers (#3) included: the program's ``graphcast.node``
spans (one a multimesh step, in the forward) summed, between their CUDA
events."""

from perfbench.harness.program import phase_ms


def read(run):
    return phase_ms(run, "graphcast.node")
