"""Kernel launches on the device per training step, from the trace (train
step layer)."""


def read(run):
    launches = len(run.trace.kernels())
    if run.unit != "step" or not run.units or not launches:
        return None
    return launches / len(run.units)
