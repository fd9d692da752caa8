"""Device ms per training step in autograd, remat's recompute included:
the program's ``step.backward`` spans, between their CUDA events."""

from perfbench.harness.program import phase_ms


def read(run):
    return phase_ms(run, "step.backward")
