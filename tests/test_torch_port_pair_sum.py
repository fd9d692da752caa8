"""The segment sums at widths that are not a multiple of 4 and the pair
segment sum (#4) against the JAX package on the same numpy inputs: the
port's plain ``csr_segment_sum_pair`` against ``pallas_segment_sum_pair``
(the Pallas kernel ``_kernel_pair``) and the plain ``csr_segment_sum``
against ``pallas_segment_sum`` (``_kernel``), both run as the JAX
package's own tests run them on the CPU (Pallas interpret mode). The JAX
functions cast fp32 or bf16 rows to fp32 and sum; the port's plain
versions do the same, and its kernels read the rows as stored and widen
them, which is exact. Tolerances are the JAX package's segment-sum ones
(tests/test_fused3_op.py:128-131), as rtol = atol. Also the pair sum's
wrapper on bf16 CPU tensors (the plain version, no cast by the caller)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from p_div_gnn_tpu.ops.scatter_pallas import pallas_segment_sum, pallas_segment_sum_pair
from p_div_gnn_tpu_torch.graphs.batching import blockify_edges
from p_div_gnn_tpu_torch.graphs.container import NODE_TILE
from p_div_gnn_tpu_torch.ops import scatter_csr

T = torch.from_numpy
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _layout(seed: int, n_tiles: int, L: int):
    """Two row streams over a receiver-sorted block-CSR layout of
    ``n_tiles`` node tiles (blocks of the layout's padding slots receive
    at their tile's last node) with a few slots set to -1: (a, b,
    receivers, block_tile, num_nodes), numpy fp32 rows."""
    rng = np.random.default_rng(seed)
    num_nodes = n_tiles * NODE_TILE
    E = 5 * num_nodes
    _, rcv, _, _, _, block_tile = blockify_edges(
        senders=rng.integers(0, num_nodes, size=E),
        receivers=np.sort(rng.integers(0, num_nodes, size=E)),
        edge_weight=np.ones(E, np.float32), edge_gid=np.zeros(E, np.int64),
        num_nodes=num_nodes, n_graphs=1,
    )
    rcv = rcv.astype(np.int32)
    rcv[rng.choice(len(rcv), size=8, replace=False)] = -1
    a, b = (rng.normal(size=(len(rcv), L)).astype(np.float32) for _ in range(2))
    return a, b, rcv, block_tile.astype(np.int32), num_nodes


@pytest.mark.parametrize("n_tiles", [1, 3])
@pytest.mark.parametrize("L", [6, 18])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pair_sum_matches_pallas(dtype, L, n_tiles):
    """The plain pair sum (#4) against ``pallas_segment_sum_pair`` on one-
    and three-tile layouts, fp32 and bf16 rows, at widths that are not a
    multiple of 4."""
    jdt, tdt, tol = DTYPES[dtype]
    a, b, rcv, bt, num_nodes = _layout(40 + L + n_tiles, n_tiles, L)
    with pltpu.force_tpu_interpret_mode():
        want = pallas_segment_sum_pair(jnp.asarray(a).astype(jdt), jnp.asarray(b).astype(jdt),
                                       jnp.asarray(rcv), jnp.asarray(bt), num_nodes)
    got = scatter_csr.csr_segment_sum_pair(T(a).to(tdt), T(b).to(tdt), T(rcv), T(bt),
                                           num_nodes, NODE_TILE)
    for x, y in zip(got, want, strict=True):
        assert x.dtype == torch.float32 and x.shape == (num_nodes, L)
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_sum_matches_pallas_at_width_18(dtype):
    """The plain block-CSR segment sum (#3) against ``pallas_segment_sum``
    at L = 18 (the kernel's wrapper pads it to 20 on the card)."""
    jdt, tdt, tol = DTYPES[dtype]
    a, _, rcv, bt, num_nodes = _layout(7, 2, 18)
    with pltpu.force_tpu_interpret_mode():
        want = pallas_segment_sum(jnp.asarray(a).astype(jdt), jnp.asarray(rcv), jnp.asarray(bt),
                                  num_nodes)
    got = scatter_csr.csr_segment_sum(T(a).to(tdt), T(rcv), T(bt), num_nodes, NODE_TILE)
    assert got.dtype == torch.float32 and got.shape == (num_nodes, 18)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


def test_pair_sum_takes_bf16_rows_on_the_cpu():
    """bf16 CPU rows go to the plain version as they are: the sums equal
    those of the rows cast to fp32 first, bit for bit, through the
    permutation too."""
    a, b, rcv, bt, num_nodes = _layout(3, 2, 16)
    a16, b16 = T(a).bfloat16(), T(b).bfloat16()
    perm = T(np.random.default_rng(4).permutation(len(rcv)).astype(np.int32))
    for p in (None, perm):
        got = scatter_csr.csr_segment_sum_pair(a16, b16, T(rcv), T(bt), num_nodes, NODE_TILE,
                                               perm=p)
        want = scatter_csr.csr_segment_sum_pair(a16.float(), b16.float(), T(rcv), T(bt),
                                                num_nodes, NODE_TILE, perm=p)
        for x, y in zip(got, want, strict=True):
            assert x.dtype == torch.float32
            assert torch.equal(x, y)
