"""% of the slots that GraphCast's edge updates ran over the traced steps
that hold no real edge: 100 · (1 − real / rows), with ``rows`` the
program's ``graphcast.edge_rows`` counter (each edge update's slots: its
set's block-CSR layout, every receiver tile's run rounded up to whole edge
blocks) and ``real`` its ``graphcast.edge_real_rows`` (the same updates'
real edges). A program without the counters gives None."""

from perfbench.harness.program import counted


def read(run):
    rows = counted(run, "graphcast.edge_rows")
    real = counted(run, "graphcast.edge_real_rows")
    if not rows or not real:
        return None
    return 100.0 * (1.0 - real / rows)
