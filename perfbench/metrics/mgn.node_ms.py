"""Device ms per training step in MeshGraphNets' node updates, the sum over
the receivers (#3) included: the program's ``mgn.node`` spans (one a block,
in the forward), between their CUDA events."""

from perfbench.harness.program import phase_ms


def read(run):
    return phase_ms(run, "mgn.node")
