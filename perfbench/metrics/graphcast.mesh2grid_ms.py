"""Device ms per training step in GraphCast's decoder: the program's
``graphcast.mesh2grid`` span (the mesh2grid embedder, the mesh2grid step
and the output MLP), between its CUDA events."""

from perfbench.harness.program import phase_ms


def read(run):
    return phase_ms(run, "graphcast.mesh2grid")
