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
from jax.flatten_util import ravel_pytree

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


def _raveled_moments(trainer):
    """The port trainer's Adam moments raveled by JAX
    (``jax.flatten_util.ravel_pytree``, as ``optax.flatten`` does) from the
    params tree: the vectors of optax.flatten's layout, in JAX's own leaf
    order rather than the port's ``flat_order``."""
    named = dict(trainer.model.named_parameters())
    st = trainer.optimizer.state
    return tuple(np.asarray(ravel_pytree(params_to_jax({n: st[p][k] for n, p in named.items()}))[0])
                 for k in ("exp_avg", "exp_avg_sq"))


def _unraveled(params, adam):
    """JAX's flat mu and nu vectors unraveled onto ``params``'s tree, as
    ``{leaf path: array}``."""
    unravel = ravel_pytree(params)[1]
    return _leaves(unravel(adam.mu)), _leaves(unravel(adam.nu))


def _assert_resumed_step_matches(trainer, port_batch, jt, params, opt_state, jax_batch):
    """One more step from the same checkpoint in both packages: the loss at
    rtol 1e-5 and the parameters at rtol 1e-5 / atol 1e-4, the tolerances of
    ``test_torch_port_train.py::test_three_adam_steps_match_jax``."""
    got = trainer.train_step(port_batch)
    params, opt_state, want = jt._train_step(params, opt_state, jax_batch)
    np.testing.assert_allclose(float(got["total"]), float(want["total"]), rtol=1e-5)
    got_p, want_p = _leaves(params_to_jax(trainer.model.state_dict())), _leaves(params)
    assert got_p.keys() == want_p.keys()
    for k in want_p:
        np.testing.assert_allclose(got_p[k], want_p[k], rtol=1e-5, atol=1e-4, err_msg=k)


def test_flatten_optimizer_identical_updates(toy, tmp_path):
    """Trainer(flatten_optimizer=True) updates as the per-parameter trainer
    does (tests/test_train_e2e.py::test_flatten_optimizer_identical_updates
    for the JAX trainer); its checkpoint holds optax.flatten(adam)'s layout,
    one mu and one nu vector in the params tree's leaf order (JAX's
    ``ravel_pytree`` of the per-parameter moments)."""
    port_batches, _, port_stats, _, _ = toy
    plain, flat = _port_trainer(port_stats), _port_trainer(port_stats)
    flat.flatten_optimizer = True
    for b in port_batches * 2:
        a, f = plain.train_step(b), flat.train_step(b)
        assert float(a["total"]) == float(f["total"])
    for (n, p), q in zip(plain.model.named_parameters(), flat.model.parameters()):
        assert torch.equal(p, q), n
    flat.save(tmp_path / "flat.ckpt", epoch=2)
    saved = read_msgpack((tmp_path / "flat.ckpt").read_bytes())["optimizer_state_dict"]["0"]
    mu, nu = _raveled_moments(plain)
    assert saved["mu"].shape == (sum(p.numel() for p in plain.model.parameters()),)
    np.testing.assert_array_equal(saved["mu"], mu)
    np.testing.assert_array_equal(saved["nu"], nu)
    assert int(saved["count"]) == 2 * len(port_batches)


@pytest.mark.parametrize("skip", [False, True], ids=["adam", "apply_if_finite"])
def test_jax_flattened_checkpoint_resumes_in_port(toy, jax_params, tmp_path, skip):
    """Each parameter's moments, by name, are JAX's flat vectors unraveled
    onto JAX's params tree; the next step matches JAX's next step."""
    port_batches, jax_batches, port_stats, jax_stats, _ = toy
    jt = _jax_trainer(jax_stats, skip, flatten_optimizer=True)
    params, opt_state = _jax_state(jt, jax_params)
    for b in jax_batches:
        params, opt_state, _ = jt._train_step(params, opt_state, b)
    jax_save(tmp_path / "jax.ckpt", params, opt_state, 4, jax_stats)

    trainer = _port_trainer(port_stats, skip)
    trainer.flatten_optimizer = True
    state_dict, epoch, _ = load_checkpoint(tmp_path / "jax.ckpt", trainer.model,
                                           trainer.optimizer, trainer.nonfinite, flat=True)
    trainer.model.load_state_dict(state_dict)
    assert epoch == 4
    adam = (opt_state.inner_state if skip else opt_state)[0]
    count, p_mu, p_nu, _ = _port_adam(trainer)
    mu, nu = _unraveled(params, adam)
    _assert_same(p_mu, mu)
    _assert_same(p_nu, nu)
    assert count == int(adam.count) == len(jax_batches)
    # the port writes back the bytes JAX wrote, and resumes from them as JAX does
    trainer.save(tmp_path / "again.ckpt", epoch=4)
    assert (tmp_path / "again.ckpt").read_bytes() == (tmp_path / "jax.ckpt").read_bytes()
    _assert_resumed_step_matches(trainer, port_batches[0], jt, params, opt_state,
                                 jax_batches[0])
    assert _port_adam(trainer)[0] == len(jax_batches) + 1


@pytest.mark.parametrize("skip", [False, True], ids=["adam", "apply_if_finite"])
def test_port_flattened_checkpoint_resumes_in_jax(toy, jax_params, tmp_path, skip):
    """JAX's flat vectors, unraveled onto the loaded params tree, hold each
    parameter's moments of the port, by name; JAX's next step from them
    matches the port's."""
    port_batches, jax_batches, port_stats, jax_stats, _ = toy
    trainer = _port_trainer(port_stats, skip)
    trainer.flatten_optimizer = True
    for b in port_batches:
        trainer.train_step(b)
    trainer.save(tmp_path / "port.ckpt", epoch=3)

    jt = _jax_trainer(jax_stats, skip, flatten_optimizer=True)
    params_t, opt_t = _jax_state(jt, jax_params)
    params, opt_state, epoch, _ = jax_load(tmp_path / "port.ckpt", params_t, opt_t)
    assert opt_state is not None and epoch == 3
    _assert_same(_leaves(params), _leaves(params_to_jax(trainer.model.state_dict())))
    adam = (opt_state.inner_state if skip else opt_state)[0]
    count, p_mu, p_nu, _ = _port_adam(trainer)
    mu, nu = _unraveled(params, adam)
    _assert_same(mu, p_mu)
    _assert_same(nu, p_nu)
    assert int(adam.count) == count == len(port_batches)
    _assert_resumed_step_matches(trainer, port_batches[0], jt, params, opt_state,
                                 jax_batches[0])
    # a flattened checkpoint is refused by a per-parameter trainer, and back
    plain = _port_trainer(port_stats, skip)
    with pytest.raises(ValueError, match="adam's layout"):
        load_checkpoint(tmp_path / "port.ckpt", plain.model, plain.optimizer, plain.nonfinite)
    plain.save(tmp_path / "plain.ckpt", epoch=1)
    with pytest.raises(ValueError, match="flatten"):
        load_checkpoint(tmp_path / "plain.ckpt", trainer.model, trainer.optimizer,
                        trainer.nonfinite, flat=True)
