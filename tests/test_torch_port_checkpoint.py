"""Checkpoints both ways between the port and the JAX package.

- The port's msgpack writer gives the bytes ``flax.serialization
  .msgpack_serialize`` gives (a tree of every type a checkpoint holds, and
  the committed ``elast_200e_div`` checkpoint re-encoded).
- A checkpoint the port wrote loads through the JAX package's
  ``load_checkpoint`` (flax, optax templates) with equal params, Adam
  ``count`` / ``mu`` / ``nu``, epoch and stats; one the JAX package wrote
  loads into the port with the same values; both with and without optax's
  ``ApplyIfFiniteState`` wrapper (``skip_nonfinite_updates``).
- Toggling ``skip_nonfinite_updates`` between writing and reading restores
  the params only, with a warning, in both packages; any other mismatch
  raises.
- The committed ``elast_200e_div`` last-epoch checkpoint resumes in the
  port: its Adam state comes back and the next step runs from it."""

from pathlib import Path

import flax.serialization
import jax
import numpy as np
import pandas as pd
import pytest
import torch

from p_div_gnn_tpu.graphs import MeshStressFieldDataset as JaxDataset
from p_div_gnn_tpu.models import EncodeProcessDecode as JaxEPD
from p_div_gnn_tpu.train.checkpoint import load_checkpoint as jax_load
from p_div_gnn_tpu.train.checkpoint import save_checkpoint as jax_save
from p_div_gnn_tpu.train.data import GraphLoader as JaxLoader
from p_div_gnn_tpu.train.loop import Trainer as JaxTrainer
from p_div_gnn_tpu_torch.graphs.batching import pack_batch
from p_div_gnn_tpu_torch.graphs.dataset import MeshStressFieldDataset
from p_div_gnn_tpu_torch.models.epd import EncodeProcessDecode
from p_div_gnn_tpu_torch.models.params import params_from_jax, params_to_jax
from p_div_gnn_tpu_torch.train.checkpoint import (
    load_checkpoint,
    read_msgpack,
    save_checkpoint,
    write_msgpack,
)
from p_div_gnn_tpu_torch.train.data import GraphLoader
from p_div_gnn_tpu_torch.train.loop import Trainer
from p_div_gnn_tpu_torch.utils.configio import read_csv

from test_train_e2e import _write_toy_dataset

ROOT = Path(__file__).resolve().parents[1]
COMMITTED = ROOT / "checkpoints/elast_200e_div/last_epoch_model_weights.ckpt"
L, STEPS = 16, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The toy models' small ops run faster on one thread than on the
    threads of a machine that the test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    root = tmp_path_factory.mktemp("toy")
    _write_toy_dataset(root, n_samples=6, seed=2)
    port = MeshStressFieldDataset(read_csv(root / "dataset.csv"))
    ref = JaxDataset(pd.read_csv(root / "dataset.csv"))
    jax_batches = list(JaxLoader(ref.samples, 3))
    return (list(GraphLoader(port.samples, 3, device="cpu")), jax_batches, port.stats,
            ref.stats, port.samples)


@pytest.fixture(scope="module")
def jax_params(toy):
    """One JAX init of the model: the params template of every test."""
    _, jax_batches, _, jax_stats, _ = toy
    return _jax_trainer(jax_stats).model.init(jax.random.PRNGKey(0), jax_batches[0], jax_stats)


def _jax_state(jt, params):
    """A fresh copy of ``params`` (the train step donates its buffers) and
    ``jt``'s optimizer state for it."""
    params = jax.tree.map(jax.numpy.array, params)
    return params, jt.optimizer.init(params)


def _jax_trainer(stats, skip=False, latent=L, **kw):
    model = JaxEPD(latent_size=latent, message_passing_steps=STEPS)
    return JaxTrainer(model=model, stats=stats, learning_rate=1e-3, divergence_penalty=10.0,
                      skip_nonfinite_updates=skip, **kw)


def _port_trainer(stats, skip=False, latent=L):
    model = EncodeProcessDecode(latent_size=latent, message_passing_steps=STEPS,
                                generator=torch.Generator().manual_seed(1))
    trainer = Trainer(model, stats, learning_rate=1e-3, divergence_penalty=10.0,
                      device="cpu", skip_nonfinite_updates=skip)
    trainer.init()
    return trainer


def _leaves(tree):
    return {jax.tree_util.keystr(path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _adam(opt_state, skip):
    """(count, mu, nu, wrapper counters) of an optax adam state."""
    wrapper = {}
    if skip:
        wrapper = {k: np.asarray(getattr(opt_state, k))
                   for k in ("notfinite_count", "last_finite", "total_notfinite")}
        opt_state = opt_state.inner_state
    adam = opt_state[0]
    return int(adam.count), _leaves(adam.mu), _leaves(adam.nu), wrapper


def _port_adam(trainer):
    named = dict(trainer.model.named_parameters())
    st = trainer.optimizer.state
    mu = _leaves(params_to_jax({n: st[p]["exp_avg"] for n, p in named.items()}))
    nu = _leaves(params_to_jax({n: st[p]["exp_avg_sq"] for n, p in named.items()}))
    counts = {int(st[p]["step"]) for p in named.values()}
    assert len(counts) == 1
    wrapper = {} if trainer.nonfinite is None else {
        k: v.numpy() for k, v in trainer.nonfinite.items()}
    return counts.pop(), mu, nu, wrapper


def _assert_same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in b:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_msgpack_writer_matches_flax():
    rng = np.random.default_rng(0)
    tree = {
        "model_state_dict": {"params": {"b": rng.normal(size=(3, 4)).astype(np.float32),
                                        "a": np.arange(5, dtype=np.int32),
                                        "t": rng.normal(size=(4, 3)).astype(np.float32).T}},
        "optimizer_state_dict": {"0": {"count": np.asarray(7, np.int32), "mu": {}, "nu": {}},
                                 "1": {}, "flag": np.asarray(True), "s": np.float32(2.5)},
        "epoch": 12, "ints": [0, 127, 128, 70000, 2**40, -1, -33, -200, -40000, -2**40],
        "stats": {"mean_pos": 50.11180114746094, "std_pos": 1e-300},
        "text": "x" * 40, "none": None, "yes": True, "big": np.zeros((300, 300), np.float32),
    }
    assert write_msgpack(tree) == flax.serialization.msgpack_serialize(tree)
    raw = COMMITTED.read_bytes()
    assert write_msgpack(read_msgpack(raw)) == raw


@pytest.mark.parametrize("skip", [False, True], ids=["adam", "apply_if_finite"])
def test_port_checkpoint_loads_in_jax(toy, jax_params, tmp_path, skip):
    port_batches, jax_batches, port_stats, jax_stats, _ = toy
    trainer = _port_trainer(port_stats, skip)
    for b in port_batches:
        trainer.train_step(b)
    trainer.save(tmp_path / "port.ckpt", epoch=3)

    params_t, opt_t = _jax_state(_jax_trainer(jax_stats, skip), jax_params)
    params, opt_state, epoch, stats = jax_load(tmp_path / "port.ckpt", params_t, opt_t)
    assert opt_state is not None and epoch == 3
    assert stats.to_dict() == jax_stats.to_dict()
    _assert_same(_leaves(params), _leaves(params_to_jax(trainer.model.state_dict())))
    count, mu, nu, wrapper = _adam(opt_state, skip)
    p_count, p_mu, p_nu, p_wrapper = _port_adam(trainer)
    assert count == p_count == len(port_batches)
    _assert_same(mu, p_mu)
    _assert_same(nu, p_nu)
    _assert_same(wrapper, p_wrapper)


@pytest.mark.parametrize("skip", [False, True], ids=["adam", "apply_if_finite"])
def test_jax_checkpoint_loads_in_port(toy, jax_params, tmp_path, skip):
    port_batches, jax_batches, port_stats, jax_stats, _ = toy
    jt = _jax_trainer(jax_stats, skip)
    params, opt_state = _jax_state(jt, jax_params)
    for b in jax_batches:
        params, opt_state, _ = jt._train_step(params, opt_state, b)
    jax_save(tmp_path / "jax.ckpt", params, opt_state, 5, jax_stats)

    trainer = _port_trainer(port_stats, skip)
    state_dict, epoch, stats = load_checkpoint(tmp_path / "jax.ckpt", trainer.model,
                                               trainer.optimizer, trainer.nonfinite)
    trainer.model.load_state_dict(state_dict)
    assert epoch == 5 and stats == port_stats
    _assert_same(_leaves(params_to_jax(trainer.model.state_dict())), _leaves(params))
    count, mu, nu, wrapper = _adam(opt_state, skip)
    p_count, p_mu, p_nu, p_wrapper = _port_adam(trainer)
    assert p_count == count == len(jax_batches)
    _assert_same(p_mu, mu)
    _assert_same(p_nu, nu)
    _assert_same(p_wrapper, wrapper)
    # and the port writes back the bytes JAX wrote
    trainer.save(tmp_path / "again.ckpt", epoch=5)
    assert (tmp_path / "again.ckpt").read_bytes() == (tmp_path / "jax.ckpt").read_bytes()


@pytest.mark.parametrize("saved_skip", [False, True], ids=["saved_adam", "saved_wrapped"])
def test_toggling_skip_nonfinite_restores_params_only(toy, jax_params, tmp_path, capsys,
                                                      saved_skip):
    port_batches, jax_batches, port_stats, jax_stats, _ = toy
    writer = _port_trainer(port_stats, saved_skip)
    writer.train_step(port_batches[0])
    writer.save(tmp_path / "w.ckpt", epoch=1)

    reader = _port_trainer(port_stats, not saved_skip)
    fresh = _port_adam(reader)
    state_dict, epoch, _ = load_checkpoint(tmp_path / "w.ckpt", reader.model,
                                           reader.optimizer, reader.nonfinite)
    assert "opposite skip_nonfinite_updates" in capsys.readouterr().out
    assert epoch == 1
    got = _port_adam(reader)
    assert got[0] == fresh[0] == 0
    for a, b in zip(got[1:], fresh[1:]):
        _assert_same(a, b)
    # the JAX package does the same with the same file
    params_t, opt_t = _jax_state(_jax_trainer(jax_stats, not saved_skip), jax_params)
    params, opt_state, _, _ = jax_load(tmp_path / "w.ckpt", params_t, opt_t)
    assert opt_state is None
    _assert_same(_leaves(params), _leaves(params_to_jax(state_dict)))


def test_other_optimizer_mismatches_raise(toy, jax_params, tmp_path):
    """An optimizer layout that is not the toggle (optax.flatten's, or
    another model's moments) raises instead of resetting Adam."""
    port_batches, jax_batches, port_stats, jax_stats, _ = toy
    params, opt_state = _jax_state(_jax_trainer(jax_stats, flatten_optimizer=True), jax_params)
    jax_save(tmp_path / "flat.ckpt", params, opt_state, 1, jax_stats)
    trainer = _port_trainer(port_stats)
    with pytest.raises(ValueError, match="adam's layout"):
        load_checkpoint(tmp_path / "flat.ckpt", trainer.model, trainer.optimizer)
    wide = _port_trainer(port_stats, latent=2 * L)
    wide.save(tmp_path / "wide.ckpt", epoch=1)
    with pytest.raises(ValueError, match="does not match"):
        load_checkpoint(tmp_path / "wide.ckpt", trainer.model, trainer.optimizer)


def test_committed_checkpoint_resumes_in_port(toy):
    samples = toy[4]
    raw = read_msgpack(COMMITTED.read_bytes())
    model = EncodeProcessDecode(latent_size=128, message_passing_steps=10, remat_steps=False)
    trainer = Trainer(model, None, device="cpu")
    trainer.init()
    state_dict, epoch, stats = load_checkpoint(COMMITTED, model, trainer.optimizer)
    model.load_state_dict(state_dict)
    trainer.stats = stats
    assert epoch == 200
    count, mu, nu, _ = _port_adam(trainer)
    assert count == int(raw["optimizer_state_dict"]["0"]["count"]) > 0
    _assert_same(mu, _leaves(raw["optimizer_state_dict"]["0"]["mu"]))
    _assert_same(nu, _leaves(raw["optimizer_state_dict"]["0"]["nu"]))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    aux = trainer.train_step(pack_batch(samples[:2], reorder="rcm"))
    assert np.isfinite(float(aux["total"]))
    assert _port_adam(trainer)[0] == count + 1
    moved = [n for n, p in model.named_parameters() if not torch.equal(p, before[n])]
    assert moved and all(bool(torch.isfinite(p).all()) for p in model.parameters())
    assert params_from_jax(raw["model_state_dict"]).keys() == before.keys()
