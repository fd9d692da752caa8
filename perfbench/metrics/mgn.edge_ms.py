"""Device ms per training step in MeshGraphNets' edge updates: the program's
``mgn.edge`` spans (one a block, in the forward), between their CUDA events."""

from perfbench.harness.program import phase_ms


def read(run):
    return phase_ms(run, "mgn.edge")
