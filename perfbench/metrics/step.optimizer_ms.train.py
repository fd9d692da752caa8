"""Device ms per training step in Adam: the program's ``step.optimizer``
spans, between their CUDA events."""

from perfbench.harness.program import phase_ms


def read(run):
    return phase_ms(run, "step.optimizer")
