"""Host syncs per training step in the layout checks of ``ops/segment.py``
(``live_slots``, ``require_consecutive_runs``): the program's
``host_sync`` counters."""

from perfbench.harness.program import counted


def read(run):
    return counted(run, "host_sync")
