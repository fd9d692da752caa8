"""% of the rows that MeshGraphNets' edge updates ran over the traced steps
that went through the edge update's kernel: 100 · fused / rows, with
``fused`` the program's ``mgn.edge_fused_rows`` counter (a block's live
slots, where its kernel ran) and ``rows`` its ``mgn.edge_rows`` (the same
slots, every block). A program without the ``mgn.edge_fused_rows`` counter
gives None."""

from perfbench.harness.program import counted


def read(run):
    fused = counted(run, "mgn.edge_fused_rows")
    rows = counted(run, "mgn.edge_rows")
    if not fused or not rows:
        return None
    return 100.0 * fused / rows
