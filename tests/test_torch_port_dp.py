"""The port's data-parallel tier against the JAX package's:
``pack_sharded_batch`` array-equal; the DP train step over 2 gloo ranks
(``parallel/launch.py::run_ranks``) against JAX's ``make_dp_train_step`` on
a 2-device CPU mesh (and the DP eval step against ``make_dp_eval_step``), for ``"xla"`` and ``"fused3"`` (JAX's kernels in Pallas
interpret mode), with the raw gradients (averaged over the ranks, before
Adam) against the single-device JAX gradient; ``Trainer(group=)``: a DP
``fit`` against the single-process ``fit``, and a resumed DP ``fit``
against a straight one; the runner's ``data_parallel`` / ``multihost``
keys over the ranks, and its refusal of fused2; ``measure_dp_scaling`` at
1 and 2 ranks on the CPU.

Tolerances are tests/test_dp.py's: step-1 loss and nmse rtol 2e-4, raw
gradients rtol 2e-3 / atol 1e-6, parameters after Adam rtol 5e-3 / atol
2e-5; fit trajectories rtol 2e-3 (parameters as after Adam); the resumed
fit rtol 1e-6 / atol 1e-7."""

import jax
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import Mesh

import torch_port_ranks as ranks
from p_div_gnn_tpu.graphs.batching import pack_batch as jax_pack_batch
from p_div_gnn_tpu.graphs.container import NormStats as JaxNormStats
from p_div_gnn_tpu.losses import batch_loss as jax_batch_loss
from p_div_gnn_tpu.models import EncodeProcessDecode as JaxEPD
from p_div_gnn_tpu.parallel.dp import device_put_sharded_batch
from p_div_gnn_tpu.parallel.dp import make_dp_eval_step as jax_dp_eval_step
from p_div_gnn_tpu.parallel.dp import make_dp_train_step as jax_dp_train_step
from p_div_gnn_tpu.parallel.dp import pack_sharded_batch as jax_pack_sharded_batch
from p_div_gnn_tpu_torch.graphs.container import NormStats
from p_div_gnn_tpu_torch.models.params import params_from_jax
from p_div_gnn_tpu_torch.parallel.dp import pack_sharded_batch, shard_of
from p_div_gnn_tpu_torch.parallel.launch import run_ranks
from p_div_gnn_tpu_torch.parallel.scaling import measure_dp_scaling
from p_div_gnn_tpu_torch.train.checkpoint import BEST_CHECKPOINT, LAST_CHECKPOINT, read_msgpack
from p_div_gnn_tpu_torch.train.data import GraphLoader
from p_div_gnn_tpu_torch.train.loop import Trainer

from test_torch_port_graphs import _to_jax_sample
from test_torch_port_partition import assert_batches_equal
from test_train_e2e import _write_toy_dataset

D, L, STEPS = 2, 16, 2
IMPLS = ("xla", "fused3")
TOY_CFG = dict(epochs=2, batch_size=2, divergence=True, latent_size=8, divergence_penalty=10.0,
               early_stopping_limit=5, learning_rate=1e-3, message_passing_steps=1,
               train_all_epochs=True, monitor_divergence_in_test=True, scatter_impl="xla")


def _state(params) -> dict:
    return {k: v.numpy() for k, v in params_from_jax(jax.tree.map(np.asarray, params)).items()}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    samples = [ranks.sample(s) for s in range(4)]
    jsamples = [_to_jax_sample(s) for s in samples]
    jstats = JaxNormStats.from_dict(ranks.STATS)
    whole = jax_pack_batch(jsamples, n_graphs=4)
    params = JaxEPD(latent_size=L, message_passing_steps=STEPS).init(
        jax.random.PRNGKey(0), whole, jstats)
    stacked = pack_sharded_batch(samples, D, graphs_per_shard=2)
    fit_params = JaxEPD(latent_size=8, message_passing_steps=1).init(
        jax.random.PRNGKey(0), whole, jstats)
    # the runner's toy dataset and config (data_parallel, multihost)
    root = tmp_path_factory.mktemp("dp")
    _write_toy_dataset(root / "train", n_samples=6, seed=0)
    _write_toy_dataset(root / "test", n_samples=3, seed=1)
    kw = dict(TOY_CFG, dataset_train_csv=str(root / "train/dataset.csv"),
              dataset_test_csv=str(root / "test/dataset.csv"))
    config = root / "dp.yml"
    config.write_text("".join(f"{k}: {v}\n" for k, v in dict(
        kw, results_folder=root / "run", data_parallel=True, multihost=True).items()))
    # the ranks run while the JAX side compiles
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(1)
    ranks_run = pool.submit(run_ranks, ranks.dp_rank, D, stacked, _state(params), list(IMPLS),
                            samples, _state(fit_params), str(root),
                            {"config": str(config), "kw": kw})
    pool.shutdown(wait=False)
    return samples, jsamples, jstats, whole, params, stacked, fit_params, root, ranks_run


@pytest.fixture(scope="module")
def port_side(setup):
    return setup[-1].result()


@pytest.fixture(scope="module")
def jax_side(setup):
    _, jsamples, jstats, whole, params, _, _, _, _ = setup
    mesh = Mesh(np.array(jax.devices()[:D]), ("data",))
    sharded = device_put_sharded_batch(
        jax_pack_sharded_batch(jsamples, n_shards=D, graphs_per_shard=2), mesh)
    optimizer = optax.adam(1e-3)
    out = {}
    for impl in IMPLS:
        model = JaxEPD(latent_size=L, message_passing_steps=STEPS, scatter_impl=impl,
                       remat_steps=False)

        def loss(p, model=model):
            pred = model.apply(p, whole, jstats, scale_output=False)
            gt = (whole.local_stress - jstats.mean_local_stress) / jstats.std_local_stress
            return jax_batch_loss(whole, pred, gt, ranks.LAMBDA, True)[0]

        step = jax_dp_train_step(model, jstats, optimizer, mesh,
                                 divergence_penalty=ranks.LAMBDA, optimize_divergence=True)
        with pltpu.force_tpu_interpret_mode():
            grads = jax.grad(loss)(params)
            fresh = jax.tree.map(np.array, params)  # the step donates them
            new_params, _, aux = step(fresh, optimizer.init(fresh), sharded)
        out[impl] = {"aux": {k: float(v) for k, v in aux.items()},
                     "grads": _state(grads), "params": _state(new_params)}
    out["eval"] = np.asarray(jax_dp_eval_step(JaxEPD(latent_size=L, message_passing_steps=STEPS),
                                              jstats, mesh)(params, sharded))
    return out


def test_pack_sharded_batch_matches_jax(setup):
    samples, jsamples, _, _, _, stacked, _, _, _ = setup
    assert_batches_equal(stacked, jax_pack_sharded_batch(jsamples, n_shards=D,
                                                         graphs_per_shard=2))
    # uneven shards: 3 graphs over 2 shards, default graphs per shard
    assert_batches_equal(pack_sharded_batch(samples[:3], D),
                         jax_pack_sharded_batch(jsamples[:3], n_shards=D))
    local = shard_of(stacked, 1)
    np.testing.assert_array_equal(local.senders, stacked.senders[1])
    assert local.n_graphs == 2 and local.snd_run_perm is None


@pytest.mark.parametrize("impl", IMPLS)
def test_dp_train_step_matches_jax(jax_side, port_side, impl):
    want = jax_side[impl]
    for r in range(D):
        got = port_side[r][impl]
        np.testing.assert_allclose(got["aux"]["total"], want["aux"]["total"], rtol=2e-4)
        np.testing.assert_allclose(got["aux"]["nmse"], want["aux"]["nmse"], rtol=2e-4)
        for k, v in want["params"].items():
            np.testing.assert_allclose(got["params"][k], v, rtol=5e-3, atol=2e-5, err_msg=k)


def test_dp_eval_step_matches_jax(setup, jax_side, port_side):
    """Each rank's prediction (stress units) with the whole batch's graph-LN
    statistics, against JAX's ``make_dp_eval_step`` (tests/test_dp.py:114)
    at the forward tolerance of tests/test_torch_port_model.py."""
    stacked = setup[5]
    for r in range(D):
        real = stacked.node_gid[r] < stacked.n_graphs
        got = port_side[r]["xla"]["eval"]
        assert got.shape == jax_side["eval"][r].shape and np.all(np.isfinite(got))
        np.testing.assert_allclose(got[real], jax_side["eval"][r][real], rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("impl", IMPLS)
def test_dp_raw_gradients_match_single_device(jax_side, port_side, impl):
    """The gradients averaged over the ranks (before Adam) are the whole
    batch's: each rank's raw gradient is D × its partial (the transposes of
    the loss's sums sum the cotangents), and their mean the true gradient.
    Adam's first step is scale-invariant, so only this check sees a sum /
    mean mix-up."""
    want = jax_side[impl]["grads"]
    for r in range(D):
        got = port_side[r][impl]["grads"]
        assert got.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=2e-3, atol=1e-6, err_msg=k)
            np.testing.assert_array_equal(got[k], port_side[0][impl]["grads"][k])


def test_dp_trainer_fit_matches_single_process(setup, port_side, tmp_path):
    """``Trainer(group=)``'s fit gives the single-process fit's trajectory
    (whole-batch semantics), the same on both ranks."""
    samples, _, _, _, _, _, fit_params, _, _ = setup
    model = ranks.model_from(_state(fit_params), 8, 1)
    tr = Trainer(model, NormStats.from_dict(ranks.STATS), divergence_penalty=ranks.LAMBDA,
                 optimize_divergence=True, monitor_divergence_in_test=True, device="cpu")
    mk = lambda: GraphLoader(samples, 4, shuffle=False, device="cpu")  # noqa: E731
    want = tr.fit(mk(), mk(), epochs=2, weights_folder=tmp_path / "single", verbose=False)
    for r in range(D):
        got = port_side[r]["fit"]
        np.testing.assert_allclose(got["fit"][0], want[0], rtol=2e-3)
        np.testing.assert_allclose(got["fit"][1], want[1], rtol=2e-3)
        for k, v in tr.model.state_dict().items():
            np.testing.assert_allclose(got["fit_params"][k], v.numpy(), rtol=5e-3, atol=2e-5,
                                       err_msg=k)
    # rank 0 wrote the checkpoints, in the single-process format
    root = setup[7]
    for name in (BEST_CHECKPOINT, LAST_CHECKPOINT):
        dp = read_msgpack((root / "fit" / name).read_bytes())
        single = read_msgpack((tmp_path / "single" / name).read_bytes())
        assert dp.keys() == single.keys() and dp["epoch"] == single["epoch"] == 2
        assert dp["optimizer_state_dict"].keys() == single["optimizer_state_dict"].keys()


def test_dp_resume_continues_trajectory(port_side):
    """DP fit 2 epochs + resume 2 more equals DP fit 4 epochs straight, on
    every rank (every rank reads the checkpoint rank 0 wrote)."""
    for r in range(D):
        got = port_side[r]["fit"]
        assert got["resumed_at"] == 2
        for k, v in got["straight"].items():
            np.testing.assert_allclose(got["resumed"][k], v, rtol=1e-6, atol=1e-7, err_msg=k)


def test_dp_skips_a_nonfinite_step_on_every_rank(port_side):
    """A non-finite value in one rank's shard: the gradients are checked
    after their all-reduce, so every rank skips the step and keeps its
    parameters (the replicas stay equal)."""
    for r in range(D):
        assert port_side[r]["fit"]["skip"] == {"count": 1, "kept": True}


def test_runner_data_parallel_over_ranks(setup, port_side):
    """``data_parallel`` and ``multihost`` from a config: both ranks train
    over the process group (the same losses), rank 0 writes the run."""
    root = setup[7]
    a, b = port_side[0]["fit"]["runner"], port_side[1]["fit"]["runner"]
    assert len(a[0]) == len(a[1]) == TOY_CFG["epochs"]
    assert a == b and np.all(np.isfinite(a[0] + a[1]))
    assert (root / "run/weights" / LAST_CHECKPOINT).is_file()
    assert (root / "run/weights" / BEST_CHECKPOINT).is_file()
    assert (root / "run/dp.yml").is_file() and (root / "run/train_logs").is_dir()


def test_runner_refuses_fused2_under_data_parallel(port_side):
    for r in range(D):
        assert "fused2" in port_side[r]["fit"]["fused2"]


def test_measure_dp_scaling_on_the_cpu():
    """The weak-scaling harness at 1 and 2 ranks (gloo): semantics only."""
    rows = measure_dp_scaling([ranks.sample(0)], device_counts=[1, 2], latent_size=8,
                              message_passing_steps=1, iters=2, device="cpu")
    assert [r["devices"] for r in rows] == [1, 2]
    assert rows[0]["efficiency"] == 1.0
    assert all(r["edges_per_s"] > 0 and r["step_s"] > 0 for r in rows)
    assert rows[1]["edges_per_s"] == pytest.approx(
        2 * ranks.sample(0).num_edges / rows[1]["step_s"])


def test_multihost_helpers_without_a_process_group(setup, monkeypatch):
    """``ensure_distributed`` is False without arguments or torchrun's
    variables (JAX: without a coordinator); ``local_device`` maps a bare
    ``cuda`` to ``cuda:LOCAL_RANK``; ``pack_global_batch`` is this rank's
    row of ``pack_sharded_batch``."""
    import torch.distributed as dist

    from p_div_gnn_tpu_torch.parallel.multihost import (
        default_backend,
        ensure_distributed,
        local_device,
        pack_global_batch,
    )

    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert ensure_distributed() is False and not dist.is_initialized()
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert local_device("cuda") == torch.device("cuda", 1)
    assert local_device("cuda:0") == torch.device("cuda", 0)
    assert local_device("cpu") == torch.device("cpu")
    assert default_backend("cpu") == "gloo" and default_backend("cuda:0") == "nccl"
    samples, stacked = setup[0], setup[5]
    local = pack_global_batch(samples, 1, D, graphs_per_shard=2, device="cpu")
    want = shard_of(stacked, 1)
    for name in want.array_fields():
        if getattr(want, name) is not None:
            np.testing.assert_array_equal(getattr(local, name).numpy(), getattr(want, name),
                                          err_msg=name)
    assert local.snd_run_perm is not None  # moved with .to(), run order derived
