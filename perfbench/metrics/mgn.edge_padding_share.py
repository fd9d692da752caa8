"""% of the rows that MeshGraphNets' edge updates ran over the traced steps
that hold no real edge: 100 · (1 − S · E / rows), with ``rows`` the
program's ``mgn.edge_rows`` counter (the edge stream's rows, once a block),
S the configuration's ``message_passing_steps`` and E the steps' real
edges. A program without the counter gives None."""

from perfbench.harness.program import counted


def read(run):
    rows = counted(run, "mgn.edge_rows")
    if not rows or not run.units:
        return None
    edges = sum(u["E"] for u in run.units) / len(run.units)
    return 100.0 * (1.0 - run.cfg["message_passing_steps"] * edges / rows)
