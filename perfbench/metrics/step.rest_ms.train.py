"""Device ms per training step in operations that are none of the port's
CUDA kernels (``kernels/*.json``): the plain tensor code of the model, the
loss and Adam, with its copies and sets."""

from perfbench.harness.yardstick import rest_seconds


def read(run):
    if run.unit != "step" or not run.units:
        return None
    rest = rest_seconds(run)
    return 1e3 * rest / len(run.units) if rest > 0 else None
