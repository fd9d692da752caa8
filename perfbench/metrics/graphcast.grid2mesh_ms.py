"""Device ms per training step in GraphCast's encoder: the program's
``graphcast.grid2mesh`` span (the embedders of the grid and mesh nodes and
of the grid2mesh and multimesh edges, and the grid2mesh step), between its
CUDA events."""

from perfbench.harness.program import phase_ms


def read(run):
    return phase_ms(run, "graphcast.grid2mesh")
