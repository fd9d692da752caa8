"""Device idle ms per training step in gaps that began while the program's
step spans were open and no CUDA runtime call was under way: the time the
card waited on the step's own host code."""

from perfbench.harness.program import host_code_idle_ms


def read(run):
    return host_code_idle_ms(run)
