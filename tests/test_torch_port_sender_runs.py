"""The sender view in run order (``GraphBatch.snd_run_perm`` /
``snd_run_sorted``, made by ``container.sender_run_order`` in
``GraphBatch.to``), which the port's block-CSR segment sum kernel reads,
against the JAX package's sender view: per node tile it holds the same
(slot, sender) pairs, each sender's slots consecutive, and the plain sums
over it match the JAX ``pallas_segment_sum`` over the JAX view (run in
interpret mode, as tests/test_scatter.py runs it) at the JAX op tests'
segment-sum tolerance (tests/test_fused3_op.py:128-131)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import p_div_gnn_tpu.ops.scatter_pallas as sp
from p_div_gnn_tpu.graphs.batching import blockify_edges as jax_blockify_edges
from p_div_gnn_tpu.graphs.batching import build_sender_view as jax_build_sender_view
from p_div_gnn_tpu_torch.graphs.container import NODE_TILE, sender_run_order
from p_div_gnn_tpu_torch.ops.scatter_csr import csr_segment_sum

T = torch.from_numpy


def _sender_view(seed: int, n_tiles: int):
    """The JAX package's sender view of a receiver layout over random
    receiver-sorted edges (the layout's padding slots all send from the last
    node), as numpy arrays, and the number of nodes."""
    rng = np.random.default_rng(seed)
    num_nodes = n_tiles * NODE_TILE
    E = 6 * num_nodes
    snd_b = jax_blockify_edges(
        rng.integers(0, num_nodes, size=E).astype(np.int32),
        np.sort(rng.integers(0, num_nodes, size=E)).astype(np.int32),
        np.ones(E, np.float32), np.zeros(E, np.int32), num_nodes=num_nodes, n_graphs=1,
    )[0]
    perm, srt, sbt = jax_build_sender_view(snd_b, num_nodes)
    return np.asarray(perm), np.asarray(srt), np.asarray(sbt), num_nodes


@pytest.mark.parametrize("seed,n_tiles", [(0, 2), (1, 3)])
def test_run_order_holds_the_views_pairs_per_tile(seed, n_tiles):
    perm, srt, sbt, _ = _sender_view(seed, n_tiles)
    run_perm, run_sorted = (t.numpy() for t in sender_run_order(T(perm), T(srt), T(sbt)))
    assert run_perm.dtype == run_sorted.dtype == np.int32
    tile_of_slot = np.repeat(sbt, len(perm) // len(sbt))
    for t in range(n_tiles):
        own = tile_of_slot == t
        want = sorted(zip(perm[own].tolist(), srt[own].tolist()))
        got = sorted(zip(run_perm[own].tolist(), run_sorted[own].tolist()))
        assert got == want, t
        # each sender's slots consecutive: senders ascend, padding (-1) last
        s = run_sorted[own].astype(np.int64) & 0xFFFFFFFF
        assert (np.diff(s) >= 0).all(), t


@pytest.mark.parametrize("seed", [0, 1])
def test_run_order_sums_match_jax_pallas_segment_sum(seed):
    perm, srt, sbt, num_nodes = _sender_view(seed, 3)
    rng = np.random.default_rng(seed + 100)
    g = rng.normal(size=(len(perm), 128)).astype(np.float32)
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        want = sp.pallas_segment_sum(jnp.asarray(g)[jnp.asarray(perm)], jnp.asarray(srt),
                                     jnp.asarray(sbt), num_nodes)
    run_perm, run_sorted = sender_run_order(T(perm), T(srt), T(sbt))
    got = csr_segment_sum(T(g), run_sorted, T(sbt), num_nodes, NODE_TILE, perm=run_perm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_graph_batch_to_derives_the_run_order():
    """GraphBatch.to adds the run order beside the JAX-equal view, which it
    leaves as it is, and array_fields (the JAX package's fields) leaves it
    out."""
    from p_div_gnn_tpu_torch.datagen.workload import build_workload

    host = build_workload(n_graphs=1, seed=0)[0]
    assert host.snd_run_perm is None and "snd_run_perm" not in host.array_fields()
    batch = host.to("cpu")
    np.testing.assert_array_equal(batch.snd_perm.numpy(), host.snd_perm)
    np.testing.assert_array_equal(batch.snd_sorted.numpy(), host.snd_sorted)
    want = sender_run_order(batch.snd_perm, batch.snd_sorted, batch.snd_block_tile)
    assert torch.equal(batch.snd_run_perm, want[0])
    assert torch.equal(batch.snd_run_sorted, want[1])


def _layouts():
    """The four index layouts a segment sum meets, as (keys, num_nodes,
    whether each key's slots are consecutive): the receiver-major and the
    pair-blocked receivers of one workload, its sender view in the JAX
    package's order and in run order."""
    from p_div_gnn_tpu_torch.datagen.workload import build_workload

    rm = build_workload(n_graphs=1, seed=0)[0].to("cpu")
    pb = build_workload(n_graphs=1, seed=0, pair_blocks=True)[0].to("cpu")
    Np = rm.num_nodes_padded
    return {
        "receiver-major": (rm.receivers, Np, True),
        "pair-blocked": (pb.receivers, pb.num_nodes_padded, False),
        "sender view, JAX order": (rm.snd_sorted, Np, False),
        "sender view, run order": (rm.snd_run_sorted, Np, True),
    }


def test_runs_are_consecutive_on_each_layout():
    """The check the CUDA segment sum and fused3 backward make before their
    kernels: it takes the layouts whose receivers run consecutively and
    refuses the two that split a receiver into several runs."""
    from p_div_gnn_tpu_torch.ops.segment import runs_are_consecutive

    for name, (keys, n, want) in _layouts().items():
        assert runs_are_consecutive(keys, n) is want, name


def test_require_consecutive_runs_checks_a_layout_once():
    """The answer is kept on the tensor with its version: a layout reused
    over steps is checked once, an edit in place is checked again."""
    from p_div_gnn_tpu_torch.ops.segment import require_consecutive_runs

    keys, n, _ = _layouts()["sender view, run order"]
    keys = keys.clone()
    require_consecutive_runs(keys, n, "test")
    assert keys._pdg_runs_checked == (keys._version, n)
    require_consecutive_runs(keys, n, "test")  # kept: no recheck
    first = int(torch.nonzero(keys >= 0)[0])
    last = int(torch.nonzero(keys >= 0)[-1])
    keys[last] = keys[first]  # the first sender now has a second run
    with pytest.raises(ValueError, match="not consecutive"):
        require_consecutive_runs(keys, n, "test")
    with pytest.raises(ValueError, match="not consecutive"):
        require_consecutive_runs(_layouts()["pair-blocked"][0], _layouts()["pair-blocked"][1],
                                 "test")


def test_pallas_scatter_takes_a_pair_blocked_batch_on_the_cpu():
    """On the CPU the pallas path's plain segment sum takes any slot order,
    as the JAX function does: on a pair-blocked batch it gives the xla
    path's output (the JAX op tests' segment-sum tolerance)."""
    from p_div_gnn_tpu_torch.datagen.workload import build_workload
    from p_div_gnn_tpu_torch.graphs.container import NormStats
    from p_div_gnn_tpu_torch.models.epd import EncodeProcessDecode

    batch = build_workload(n_graphs=1, seed=0, pair_blocks=True)[0].to("cpu")
    out = {}
    for impl in ("pallas", "xla"):
        model = EncodeProcessDecode(16, 1, scatter_impl=impl,
                                    generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            out[impl] = model(batch, NormStats.ones())
    torch.testing.assert_close(out["pallas"], out["xla"], rtol=1e-4, atol=1e-4)
