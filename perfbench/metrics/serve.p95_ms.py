"""The 95th percentile of the request latencies (call to returned fields)
of the run's untimed-by-the-profiler window, which precedes the traced
one: at capacity, as the closed loop keeps the server, the tail swings
with the smallest change, so it is a per-layer reading and not held."""

import numpy as np


def read(run):
    latencies = run.spans.get("request", [])
    if run.unit != "request" or len(latencies) < 20:
        return None
    return 1e3 * float(np.percentile(latencies, 95))
