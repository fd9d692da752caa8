"""The port's edge-partitioned tier against the JAX package's: the planner
(``partition_batch``, both halo modes, D = 4, also on a >= 10k-node graded
mesh) and ``pad_sender_view`` array-equal; the partitioned forward and train
step over 4 gloo ranks (``parallel/launch.py::run_ranks``) against JAX's
``make_partitioned_{forward,train_step}`` on the 8-device CPU mesh, for
``"xla"`` and ``"fused3"`` (JAX's fused3 kernels in Pallas interpret mode,
as its own tests run them), both halo modes; the halo exchange's order and
wire dtype, from a spy on the collective.

The batch: two periodic plate-with-hole meshes (Np = 768, three node tiles),
so shards 0-2 own a tile each with real ghosts across the cuts, and shard 3
owns nothing and still runs.

Tolerances are the JAX package's own (tests/test_partition.py:52-111):
forward rtol 5e-4 / atol 5e-5; train step total and nmse rtol 5e-4,
divergence 5e-3, parameters after Adam rtol 5e-3 / atol 5e-5; the raw
gradients (averaged over the ranks, before Adam) against the single-device
JAX gradient at tests/test_dp.py:86-89's rtol 2e-3 / atol 1e-6."""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import Mesh

import torch_port_ranks as ranks
from p_div_gnn_tpu.graphs.batching import pack_batch as jax_pack_batch
from p_div_gnn_tpu.graphs.batching import pad_sender_view as jax_pad_sender_view
from p_div_gnn_tpu.graphs.container import NormStats as JaxNormStats
from p_div_gnn_tpu.losses import batch_loss as jax_batch_loss
from p_div_gnn_tpu.models import EncodeProcessDecode as JaxEPD
from p_div_gnn_tpu.parallel.partition import device_put_partitioned
from p_div_gnn_tpu.parallel.partition import make_partitioned_forward as jax_forward
from p_div_gnn_tpu.parallel.partition import make_partitioned_train_step as jax_train_step
from p_div_gnn_tpu.parallel.partition import partition_batch as jax_partition_batch
from p_div_gnn_tpu_torch.datagen.mesher import hole_plate_mesh
from p_div_gnn_tpu_torch.graphs.batching import pack_batch, pad_sender_view
from p_div_gnn_tpu_torch.models.epd import EncodeProcessDecode, Halo
from p_div_gnn_tpu_torch.models.params import params_from_jax
from p_div_gnn_tpu_torch.parallel.launch import run_ranks
from p_div_gnn_tpu_torch.parallel.partition import partition_batch

from test_torch_port_graphs import _to_jax_sample

D, L, STEPS = 4, 16, 2
MODES = ("a2a", "all_gather")
CASES = [(impl, mode) for impl in ("xla", "fused3") for mode in MODES]
case_id = "{0[0]}-{0[1]}".format


def assert_batches_equal(port, ref):
    for name in port.array_fields():
        got, want = getattr(port, name), getattr(ref, name)
        assert (got is None) == (want is None), name
        if got is not None:
            np.testing.assert_array_equal(got, np.asarray(want), err_msg=name)
    assert (port.n_graphs, port.tile) == (ref.n_graphs, ref.tile)


@pytest.fixture(scope="module")
def setup():
    samples = [ranks.sample(s, size=6.0) for s in (0, 1)]
    host = pack_batch(samples, n_graphs=2)
    ref = jax_pack_batch([_to_jax_sample(s) for s in samples], n_graphs=2)
    jstats = JaxNormStats.from_dict(ranks.STATS)
    params = JaxEPD(latent_size=L, message_passing_steps=STEPS).init(
        jax.random.PRNGKey(0), ref, jstats)
    plans = {mode: partition_batch(host, D, halo_mode=mode) for mode in MODES}
    ref_plans = {mode: jax_partition_batch(ref, D, halo_mode=mode) for mode in MODES}
    # the port's ranks run while the JAX side compiles
    state = {k: v.numpy() for k, v in params_from_jax(jax.tree.map(np.asarray, params)).items()}
    pool = ThreadPoolExecutor(1)
    ranks_run = pool.submit(run_ranks, ranks.partition_rank, D, plans, state, L, STEPS, CASES)
    pool.shutdown(wait=False)
    return host, ref, jstats, params, plans, ref_plans, ranks_run


@pytest.fixture(scope="module")
def jax_side(setup):
    """JAX's partitioned forward, train step and single-device gradients."""
    _, ref, jstats, params, _, ref_plans, _ = setup
    mesh = Mesh(np.array(jax.devices()[:D]), ("graph",))
    optimizer = optax.adam(1e-3)
    out = {}
    for impl, mode in CASES:
        model = JaxEPD(latent_size=L, message_passing_steps=STEPS, scatter_impl=impl,
                       remat_steps=False)

        def loss(p, model=model):
            pred = model.apply(p, ref, jstats, scale_output=False)
            gt = (ref.local_stress - jstats.mean_local_stress) / jstats.std_local_stress
            return jax_batch_loss(ref, pred, gt, ranks.LAMBDA, True)[0]

        stacked, send_idx = device_put_partitioned(*ref_plans[mode], mesh)
        with pltpu.force_tpu_interpret_mode():
            grads = jax.grad(loss)(params)
            local = jax_forward(model, jstats, mesh, scale_output=True)(params, stacked, send_idx)
            step = jax_train_step(model, jstats, optimizer, mesh,
                                  divergence_penalty=ranks.LAMBDA, optimize_divergence=True)
            # the step donates its parameters and optimizer state
            fresh = jax.tree.map(np.array, params)
            new_params, _, aux = step(fresh, optimizer.init(fresh), stacked, send_idx)
        out[(impl, mode)] = {
            "fwd": np.asarray(local), "aux": {k: float(v) for k, v in aux.items()},
            "grads": {k: v.numpy() for k, v in params_from_jax(
                jax.tree.map(np.asarray, grads)).items()},
            "params": {k: v.numpy() for k, v in params_from_jax(
                jax.tree.map(np.asarray, new_params)).items()}}
    return out


@pytest.fixture(scope="module")
def port_side(setup):
    """The port's partitioned forward and train step on 4 gloo ranks."""
    return setup[-1].result()


@pytest.mark.parametrize("mode", MODES)
def test_partition_batch_matches_jax(setup, mode):
    host, _, _, _, plans, ref_plans, _ = setup
    (stacked, send_idx), (want, want_idx) = plans[mode], ref_plans[mode]
    assert_batches_equal(stacked, want)
    np.testing.assert_array_equal(send_idx, np.asarray(want_idx))
    # three shards own a node tile each and exchange real ghosts; the
    # fourth owns nothing
    real = stacked.node_gid < stacked.n_graphs
    assert real[:3].any(axis=1).all() and not real[3].any()
    Nl = stacked.pos.shape[1]
    assert (stacked.senders[:3] >= Nl).any(), "no edge reads a ghost row"


@pytest.mark.parametrize("mode", MODES)
def test_partition_batch_matches_jax_at_scale(mode):
    """The >= 10k-node graded mesh of tests/test_partition.py:113."""
    kw = dict(radius=20.0, hole_center=(50.0, 50.0), hole_refinement_factor=3.0,
              global_mesh_refinement_size=0.92, seed=3)
    s = ranks.sample_from_mesh(hole_plate_mesh(100.0, 100.0, **kw), np.random.default_rng(0))
    assert s.num_nodes >= 10_000
    host = pack_batch([s], n_graphs=1)
    ref = jax_pack_batch([_to_jax_sample(s)], n_graphs=1)
    stacked, send_idx = partition_batch(host, D, halo_mode=mode)
    want, want_idx = jax_partition_batch(ref, D, halo_mode=mode)
    assert_batches_equal(stacked, want)
    np.testing.assert_array_equal(send_idx, np.asarray(want_idx))
    # the plan's capacity blow-up stays low (tests/test_partition.py:148)
    assert stacked.senders.shape[-1] * D <= 1.25 * host.num_edges_padded


def test_pad_sender_view_matches_jax(setup):
    host = setup[0]
    n = host.num_nodes_padded
    cap = len(host.snd_perm) + 3 * 768
    got = pad_sender_view(host.snd_perm, host.snd_sorted, host.snd_block_tile, cap, n)
    want = jax_pad_sender_view(host.snd_perm, host.snd_sorted, host.snd_block_tile, cap, n)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a, b)
    assert pad_sender_view(host.snd_perm, host.snd_sorted, host.snd_block_tile,
                           len(host.snd_perm), n)[0] is host.snd_perm
    with pytest.raises(ValueError):
        pad_sender_view(host.snd_perm, host.snd_sorted, host.snd_block_tile, cap + 1, n)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_partitioned_forward_matches_jax(setup, jax_side, port_side, case):
    stacked = setup[4][case[1]][0]
    want = jax_side[case]["fwd"]
    for r in range(D):
        real = stacked.node_gid[r] < stacked.n_graphs
        got = port_side[r][case]["fwd"]
        assert np.all(np.isfinite(got))
        np.testing.assert_allclose(got[real], want[r][real], rtol=5e-4, atol=5e-5)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_partitioned_train_step_matches_jax(jax_side, port_side, case):
    want = jax_side[case]
    for r in range(D):
        got = port_side[r][case]
        np.testing.assert_allclose(got["aux"]["total"], want["aux"]["total"], rtol=5e-4)
        np.testing.assert_allclose(got["aux"]["nmse"], want["aux"]["nmse"], rtol=5e-4)
        np.testing.assert_allclose(got["aux"]["divergence"], want["aux"]["divergence"],
                                   rtol=5e-3)
        for k, v in want["params"].items():
            np.testing.assert_allclose(got["params"][k], v, rtol=5e-3, atol=5e-5, err_msg=k)
    # the replicated update stays replicated
    for r in range(1, D):
        for k, v in port_side[0][case]["params"].items():
            np.testing.assert_array_equal(port_side[r][case]["params"][k], v, err_msg=k)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_partitioned_raw_gradients_match_single_device(jax_side, port_side, case):
    """The gradients averaged over the ranks, before Adam, are the whole
    batch's gradient: a sum / mean mix-up in the collectives' transposes
    would scale them by D, which Adam's first step would hide."""
    want = jax_side[case]["grads"]
    for r in range(D):
        got = port_side[r][case]["grads"]
        assert got.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=2e-3, atol=1e-6, err_msg=k)


def test_partitioned_step_with_remat_gives_the_same_gradients(port_side):
    """With remat the backward runs each step's exchange and its sums again
    (the same collectives in the same order on every rank): the gradients
    equal the step without remat's."""
    for r in range(D):
        want = port_side[r][("fused3", "a2a")]["grads"]
        for k, v in port_side[r]["remat"].items():
            np.testing.assert_allclose(v, want[k], rtol=1e-6, atol=1e-9, err_msg=k)


def _exchanges(events):
    """(issue index, wait index, matmuls in between, dtype, async_op) of each
    exchange the spy saw."""
    out, open_ = [], None
    for i, ev in enumerate(events):
        if ev[0] == "issue":
            open_ = (i, ev)
        elif ev[0] == "wait":
            j, issue = open_
            between = sum(1 for e in events[j:i] if e[0] == "matmul")
            out.append((j, i, between, issue[2], issue[3]))
    return out


def test_halo_exchange_overlaps_local_projections(port_side):
    """"xla" issues each step's exchange of raw node latents before its local
    projections and waits only where the ghost rows are first projected:
    x·Wu, x·Wv and e·We run while the exchange is in flight (the counterpart
    of tests/test_overlap.py's independent dots), and the ghost projections
    after the wait."""
    for r in range(D):
        events = port_side[r][("spy", "xla")]
        ex = _exchanges(events)
        assert len(ex) == STEPS
        for j, i, between, dtype, async_op in ex:
            assert async_op is True and dtype == "torch.float32"
            assert between >= 2, events
            assert events[i + 1][0] == "matmul"  # the ghosts' projection


def test_fused3_halo_exchange_rides_in_stream_dtype(port_side):
    """fused3 sends its ghosts in the stream dtype: bf16 on the wire in
    bf16 mode (half the bytes)."""
    for r in range(D):
        ex = _exchanges(port_side[r][("spy", "fused3")])
        assert len(ex) == STEPS
        assert all(dtype == "torch.bfloat16" for _, _, _, dtype, _ in ex)


def test_fused2_refuses_a_halo(setup):
    """fused2 is single-shard, as the JAX Processor asserts (epd.py:253)."""
    stacked = setup[4]["a2a"][0]
    from p_div_gnn_tpu_torch.graphs.container import NormStats
    from p_div_gnn_tpu_torch.parallel.dp import shard_of

    model = EncodeProcessDecode(latent_size=L, message_passing_steps=1, scatter_impl="fused2")
    halo = Halo(torch.zeros(D, 8, dtype=torch.int32), group=None)
    with pytest.raises(ValueError, match="fused2"):
        model(shard_of(stacked, 0).to("cpu"), NormStats.ones(), halo=halo)
