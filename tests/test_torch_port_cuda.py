"""The fused edge-step CUDA kernel against its plain PyTorch version on the
card. It imports neither JAX nor the JAX package, so it runs where the card
is (that machine has no JAX; skip the repo's conftest there):

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q

Without a card the tests skip. chip_smoke.py makes the same check at the
flagship shapes. Tolerances: the JAX package's fused3 op tolerances
(tests/test_fused3_op.py:65-70 fp32, :128 bf16)."""

import numpy as np
import pytest
import torch

from p_div_gnn_tpu_torch.graphs.batching import blockify_edges
from p_div_gnn_tpu_torch.graphs.container import NODE_TILE
from p_div_gnn_tpu_torch.ops import fused_edge3

T = torch.from_numpy


def _edge_problem(seed: int, n_tiles: int, L: int):
    """Random receiver-sorted edges in the block-aligned CSR layout, with a
    second graph's worth of padding slots; numpy inputs for both packages."""
    rng = np.random.default_rng(seed)
    num_nodes = n_tiles * NODE_TILE
    E = 6 * num_nodes
    rcv = np.sort(rng.integers(0, num_nodes, size=E))
    snd = rng.integers(0, num_nodes, size=E)
    snd_b, rcv_b, _, gid_b, _, block_tile = blockify_edges(
        senders=snd, receivers=rcv, edge_weight=np.ones(E, np.float32),
        edge_gid=np.zeros(E, np.int64), num_nodes=num_nodes, n_graphs=1,
    )
    Ep = len(rcv_b)
    f32 = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)  # noqa: E731
    x = f32(num_nodes, L)
    arrays = {
        "x": x, "g_x": x[snd_b], "e": f32(Ep, L),
        "w_u": f32(L, L, scale=L**-0.5), "w_v": f32(L, L, scale=L**-0.5),
        "w_e": f32(L, L, scale=L**-0.5), "b0": f32(L),
        "w2": f32(L, L, scale=L**-0.5), "b2": f32(L),
    }
    idx = {"receivers": rcv_b.astype(np.int32), "edge_gid": gid_b.astype(np.int32),
           "block_tile": block_tile.astype(np.int32)}
    return arrays, idx


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_reference_on_cuda(dtype):
    """Three node tiles, L = 128; the launch count rises by one per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    arrays, idx = _edge_problem(5, 3, L=128)
    args = [T(a).to("cuda", dtype) for a in arrays.values()]
    rcv, gid, bt = (T(idx[k]).cuda() for k in ("receivers", "edge_gid", "block_tile"))
    before = fused_edge3.fused_edge_step3.launches
    got = fused_edge3.fused_edge_step3(*args, rcv, (gid, bt), 1, NODE_TILE)
    assert fused_edge3.fused_edge_step3.launches == before + 1
    want = fused_edge3.fused_edge_step3_reference(*args, rcv, gid, 1)
    tols = (1e-5, 1e-4, 1e-3) if dtype == torch.float32 else (3e-2,) * 3
    for a, b, tol in zip(got, want, tols):
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)
