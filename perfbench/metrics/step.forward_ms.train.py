"""Device ms per training step in the model's forward and the loss: the
program's ``step.forward`` spans, between their CUDA events."""

from perfbench.harness.program import phase_ms


def read(run):
    return phase_ms(run, "step.forward")
