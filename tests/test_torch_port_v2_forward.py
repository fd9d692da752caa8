"""The CPU side of the v2 (#5, ``fused_edge_step``) and pair-blocked (#7,
``fused_edge_step2``) forwards, whose kernels walk receiver runs: the list
of real slots the pair-blocked kernels walk (``pair_entries``), the run
check the v2 forward's wrapper makes on the layouts the port packs, and the
plain versions against the JAX functions (``_step_kernel`` and
``_step2_kernel`` in Pallas interpret mode, as the JAX package's own tests
run them on the CPU) at the widths the kernels are built for beside 128: 64
and 256. Tolerances are the JAX v2 op's (tests/test_fused_op.py:86-91), 3e-2
for bf16 streams (tests/test_fused3_op.py:128), as rtol = atol."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from p_div_gnn_tpu.ops.fused_edge import fused_edge_step as jax_step
from p_div_gnn_tpu.ops.fused_edge import fused_edge_step2 as jax_step2
from p_div_gnn_tpu_torch.graphs import batching
from p_div_gnn_tpu_torch.graphs.container import NODE_TILE
from p_div_gnn_tpu_torch.ops import fused_edge
from p_div_gnn_tpu_torch.ops.segment import require_consecutive_runs, runs_are_consecutive

from test_torch_port_cuda import _pair_problem, _v2_problem
from test_torch_port_graphs import _port_sample

T = torch.from_numpy
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
FWD_TOL = {"float32": (1e-5, 1e-4, 1e-3), "bfloat16": (3e-2,) * 3}
PAIR_AUX = ("edge_gid", "block_tile", "block_snd_tile", "snd_perm", "snd_sorted",
            "snd_block_tile")


def _pair_layout(layout: str):
    """A pair-blocked layout as the pair-blocked kernels take it:
    (receivers, senders, edge_gid, block_tile, block_snd_tile, n_graphs,
    tile) as CPU tensors and ints. "tiles1" / "tiles3": ``_pair_problem``
    over one or three node tiles (three: a stray receiver and a stray
    sender); "packed" / "packed_rcm": three meshes through ``pack_batch``
    (pair_blocks=True), without and with the RCM order."""
    if layout.startswith("tiles"):
        _, idx = _pair_problem(3, int(layout[-1]), L=8)
        parts = [T(np.asarray(idx[k], np.int32)) for k in
                 ("receivers", "senders", "edge_gid", "block_tile", "block_snd_tile")]
        return (*parts, 1, NODE_TILE)
    b = batching.pack_batch([_port_sample(s) for s in (0, 1, 2)], n_graphs=4,
                            reorder="rcm" if layout == "packed_rcm" else None,
                            pair_blocks=True)
    parts = [T(np.asarray(getattr(b, k), np.int32)) for k in
             ("receivers", "senders", "edge_gid", "edge_block_tile", "edge_block_snd_tile")]
    return (*parts, b.n_graphs, b.tile)


@pytest.mark.parametrize("layout", ["tiles1", "tiles3", "packed", "packed_rcm"])
def test_pair_entries_list_the_real_slots_by_receiver(layout):
    """Every slot appears exactly once: first the real slots, stably sorted
    by receiver (so each receiver's slots are one run), then the padding
    slots in order; an entry's receiver and sender are -1 exactly where the
    endpoint lies outside its block's tile. The list is kept on edge_gid
    and reused, and made anew after an in-place edit of the layout."""
    rcv, snd, gid, bt, bst, n_graphs, tile = _pair_layout(layout)
    Ep = rcv.shape[0]
    entries = fused_edge.pair_entries(rcv, snd, gid, bt, bst, n_graphs, tile)
    slot, e_rcv, e_snd, pad = entries
    assert all(t.dtype == torch.int32 for t in entries)
    assert torch.equal(torch.sort(torch.cat([slot, pad])).values, torch.arange(Ep).int())
    real = gid < n_graphs
    assert torch.equal(torch.sort(slot).values, torch.nonzero(real).flatten().int())
    assert torch.equal(pad, torch.nonzero(~real).flatten().int())
    s = slot.long()
    block = s // (Ep // bt.shape[0])
    in_r = rcv[s] // tile == bt[block]
    in_s = snd[s] // tile == bst[block]
    assert torch.equal(e_rcv, torch.where(in_r, rcv[s], -1))
    assert torch.equal(e_snd, torch.where(in_s, snd[s], -1))
    if layout == "tiles3":
        assert (e_rcv < 0).any() and (e_snd < 0).any(), "stray endpoints"
    # stably sorted by receiver: receivers non-decreasing, slots rising
    # within a receiver
    assert (e_rcv[1:] >= e_rcv[:-1]).all()
    same = e_rcv[1:] == e_rcv[:-1]
    assert (slot[1:][same] > slot[:-1][same]).all()
    assert runs_are_consecutive(e_rcv, rcv.max().item() + 1)
    again = fused_edge.pair_entries(rcv, snd, gid, bt, bst, n_graphs, tile)
    assert all(a is b for a, b in zip(entries, again))
    rcv.add_(0)  # an in-place edit: the layout's version moves on
    fresh = fused_edge.pair_entries(rcv, snd, gid, bt, bst, n_graphs, tile)
    assert fresh[0] is not slot
    assert all(torch.equal(a, b) for a, b in zip(entries, fresh))


@pytest.mark.parametrize("reorder", [None, "rcm"])
@pytest.mark.parametrize("packer", ["predictor", "trainer"])
def test_v2_layouts_give_each_receiver_one_run(packer, reorder):
    """The receiver-major batches the port packs for the v2 path, as
    Predictor packs them (no sender view, no divergence views) and as the
    trainer's workload packs them (both), without and with the RCM order,
    give each receiver one run: the v2 forward's run check, which the CUDA
    wrapper makes before its launch, refuses none of them."""
    samples = [_port_sample(s) for s in (0, 1, 2)]
    if packer == "predictor":
        b = batching.pack_batch(samples, reorder=reorder, sender_view=False, div_ell=False)
    else:
        b = batching.pack_batch(samples, n_graphs=len(samples), reorder=reorder)
    rcv = T(np.asarray(b.receivers, np.int32))
    assert runs_are_consecutive(rcv, b.num_nodes_padded)
    require_consecutive_runs(rcv, b.num_nodes_padded, "fused_edge_step")
    # the pair-blocked layout of the same meshes splits receivers' runs
    pair = batching.pack_batch(samples, reorder=reorder, sender_view=False, div_ell=False,
                               pair_blocks=True)
    assert not runs_are_consecutive(T(np.asarray(pair.receivers, np.int32)),
                                    pair.num_nodes_padded)


def _close(got, want, dtype):
    assert got[0].dtype == DTYPES[dtype][1] and got[1].dtype == got[2].dtype == torch.float32
    for name, a, b, tol in zip(("z_upd", "R", "M"), got, want, FWD_TOL[dtype]):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b.astype(jnp.float32)),
                                   rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("L", [64, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_v2_forward_matches_jax_at_built_widths(dtype, L):
    """The v2 step's forward (its plain version, on CPU tensors) against
    JAX ``fused_edge_step`` at L = 64 and 256, over two node tiles, one
    without a real edge."""
    jdt, tdt = DTYPES[dtype]
    arrays, idx = _v2_problem(31, 2, L=L, empty_tile=1)
    args = tuple(jnp.asarray(a).astype(jdt) for a in arrays.values())
    aux = (jnp.asarray(idx["edge_gid"]), jnp.asarray(idx["block_tile"]))
    with pltpu.force_tpu_interpret_mode():
        want = jax_step(*args, jnp.asarray(idx["receivers"]), aux, 1)
    got = fused_edge.fused_edge_step(*(T(a).to(tdt) for a in arrays.values()),
                                     T(idx["receivers"]),
                                     (T(idx["edge_gid"]), T(idx["block_tile"])), 1, NODE_TILE)
    _close(got, want, dtype)


@pytest.mark.parametrize("L", [64, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pair_forward_matches_jax_at_built_widths(dtype, L):
    """The pair-blocked step's forward (its plain version, on CPU tensors)
    against JAX ``fused_edge_step2`` at L = 64 and 256, over two node
    tiles, with padding slots and a receiver and a sender outside their
    block's tiles."""
    jdt, tdt = DTYPES[dtype]
    arrays, idx = _pair_problem(32, 2, L=L)
    args = tuple(jnp.asarray(a).astype(jdt) for a in arrays.values())
    with pltpu.force_tpu_interpret_mode():
        want = jax_step2(*args, jnp.asarray(idx["receivers"]), jnp.asarray(idx["senders"]),
                         tuple(jnp.asarray(idx[k]) for k in PAIR_AUX), 1)
    got = fused_edge.fused_edge_step2(*(T(a).to(tdt) for a in arrays.values()),
                                      T(idx["receivers"]), T(idx["senders"]),
                                      tuple(T(np.array(idx[k])) for k in PAIR_AUX), 1,
                                      NODE_TILE)
    _close(got, want, dtype)
