"""The port's ``Trainer.fit`` and its skipping of non-finite updates against
the JAX package's, from one JAX init (``params_from_jax``) on the same toy
on-disk dataset (``tests/test_train_e2e.py::_write_toy_dataset``) through
both packages' loaders. The JAX fused3 path runs in Pallas interpret mode;
the port's runs its kernels' plain versions on the CPU.

Tolerances are those of ``test_torch_port_train.py::
test_three_adam_steps_match_jax``: rtol 1e-5 on the per-epoch losses (the
logged scalars too), rtol 1e-5 / atol 1e-4 on the parameters; Adam's
moments, which carry the gradients' rounding differences, at the gradient
tolerance of ``test_loss_gradient_matches_jax``, rtol = atol = 2e-4."""

import json

import jax
import numpy as np
import pandas as pd
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from p_div_gnn_tpu.graphs import MeshStressFieldDataset as JaxDataset
from p_div_gnn_tpu.models import EncodeProcessDecode as JaxEPD
from p_div_gnn_tpu.models.summary import model_summary as jax_model_summary
from p_div_gnn_tpu.train.data import GraphLoader as JaxLoader
from p_div_gnn_tpu.train.logging import MetricsWriter as JaxWriter
from p_div_gnn_tpu.train.loop import Trainer as JaxTrainer
from p_div_gnn_tpu_torch.graphs.dataset import MeshStressFieldDataset
from p_div_gnn_tpu_torch.models.epd import EncodeProcessDecode
from p_div_gnn_tpu_torch.models.params import params_from_jax, params_to_jax
from p_div_gnn_tpu_torch.models.summary import model_summary
from p_div_gnn_tpu_torch.train.checkpoint import (
    BEST_CHECKPOINT,
    LAST_CHECKPOINT,
    load_checkpoint,
    read_msgpack,
)
from p_div_gnn_tpu_torch.train.data import GraphLoader
from p_div_gnn_tpu_torch.train.logging import MetricsWriter
from p_div_gnn_tpu_torch.train.loop import Trainer
from p_div_gnn_tpu_torch.utils.configio import read_csv

from test_train_e2e import _write_toy_dataset

L, STEPS, LAMBDA = 16, 2, 10.0
LOSS_RTOL, P_RTOL, P_ATOL, GRAD_TOL = 1e-5, 1e-5, 1e-4, 2e-4


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
    _write_toy_dataset(root / "train", n_samples=6, seed=0)
    _write_toy_dataset(root / "test", n_samples=3, seed=1)
    out = {}
    for split in ("train", "test"):
        csv = root / split / "dataset.csv"
        out[split] = (MeshStressFieldDataset(read_csv(csv)), JaxDataset(pd.read_csv(csv)))
    return out


def _pair(toy, impl, lr=1e-3, monitor=True, skip=False, max_nonfinite=100):
    """(port trainer, JAX trainer, JAX params, JAX opt state) from one JAX
    init, with the train set's stats."""
    port_ds, jax_ds = toy["train"]
    jax_model = JaxEPD(latent_size=L, message_passing_steps=STEPS, scatter_impl=impl,
                       remat_steps=False)
    jt = JaxTrainer(model=jax_model, stats=jax_ds.stats, learning_rate=lr,
                    divergence_penalty=LAMBDA, optimize_divergence=True,
                    monitor_divergence_in_test=monitor, skip_nonfinite_updates=skip,
                    _max_consecutive_nonfinite=max_nonfinite)
    params, opt_state = jt.init(jax.random.PRNGKey(0),
                                next(iter(JaxLoader(jax_ds.samples, 3))))
    model = EncodeProcessDecode(latent_size=L, message_passing_steps=STEPS,
                                scatter_impl=impl, remat_steps=False)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    pt = Trainer(model, port_ds.stats, learning_rate=lr, divergence_penalty=LAMBDA,
                 optimize_divergence=True, monitor_divergence_in_test=monitor,
                 device="cpu", skip_nonfinite_updates=skip,
                 _max_consecutive_nonfinite=max_nonfinite)
    pt.init()
    return pt, jt, params, opt_state


def _loaders(toy, sender_view=True):
    (p_tr, j_tr), (p_te, j_te) = toy["train"], toy["test"]
    port = (GraphLoader(p_tr.samples, 3, shuffle=True, seed=1, sender_view=sender_view,
                        device="cpu"),
            GraphLoader(p_te.samples, 3, sender_view=sender_view, device="cpu"))
    ref = (JaxLoader(j_tr.samples, 3, shuffle=True, seed=1, sender_view=sender_view),
           JaxLoader(j_te.samples, 3, sender_view=sender_view))
    return port, ref


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _records(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def _fit_both(toy, tmp_path, impl, epochs, test_set=True, **fit_kw):
    pt, jt, params, opt_state = _pair(toy, impl)
    (ptr, pte), (jtr, jte) = _loaders(toy, sender_view=impl != "xla")
    if not test_set:
        pte, jte = [], []
    with JaxWriter(tmp_path / "jax" / "logs") as w, pltpu.force_tpu_interpret_mode():
        *_, j_train, j_test = jt.fit(params, opt_state, jtr, jte, epochs,
                                     tmp_path / "jax" / "weights", writer=w, verbose=False,
                                     **fit_kw)
    with MetricsWriter(tmp_path / "port" / "logs") as w:
        p_train, p_test = pt.fit(ptr, pte, epochs, tmp_path / "port" / "weights", writer=w,
                                 verbose=False, **fit_kw)
    return (p_train, p_test), (j_train, j_test)


def _assert_same_run(tmp_path):
    """Same checkpoint files (params at the tolerance, the epoch and stats
    equal) and the same logged tags and steps, values at rtol 1e-5."""
    port, ref = tmp_path / "port", tmp_path / "jax"
    names = sorted(p.name for p in (ref / "weights").iterdir())
    assert names == sorted(p.name for p in (port / "weights").iterdir())
    assert names == sorted([BEST_CHECKPOINT, LAST_CHECKPOINT])
    for name in names:
        got, want = read_msgpack((port / "weights" / name).read_bytes()), read_msgpack(
            (ref / "weights" / name).read_bytes())
        assert got["epoch"] == want["epoch"] and got["stats"] == pytest.approx(want["stats"],
                                                                              rel=1e-6)
        g, w = _leaves(got["model_state_dict"]), _leaves(want["model_state_dict"])
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=P_RTOL, atol=P_ATOL, err_msg=k)
        assert int(got["optimizer_state_dict"]["0"]["count"]) == int(
            want["optimizer_state_dict"]["0"]["count"])
    got, want = _records(port / "logs" / "metrics.jsonl"), _records(ref / "logs" / "metrics.jsonl")
    assert [(r["tag"], r["step"]) for r in got] == [(r["tag"], r["step"]) for r in want]
    np.testing.assert_allclose([r["value"] for r in got], [r["value"] for r in want],
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("impl", ["xla", "fused3"])
def test_fit_matches_jax(toy, tmp_path, impl):
    """Two epochs: per-epoch train and test losses, both checkpoint files
    and the JSONL scalars."""
    (p_train, p_test), (j_train, j_test) = _fit_both(toy, tmp_path, impl, epochs=2,
                                                     train_all_epochs=True)
    assert len(p_train) == len(j_train) == 2
    np.testing.assert_allclose(p_train, j_train, rtol=LOSS_RTOL)
    np.testing.assert_allclose(p_test, j_test, rtol=LOSS_RTOL)
    _assert_same_run(tmp_path)
    tags = {r["tag"] for r in _records(tmp_path / "port" / "logs" / "metrics.jsonl")}
    assert tags == {"Loss/MSE Train", "Loss/Loss Train", "Loss/MSE Test",
                    "Loss/Divergence Train", "Loss/Divergence test value"}


def test_early_stopping_matches_jax(toy, tmp_path):
    """``early_stopping_limit=1`` on a run whose test loss cannot improve
    (an empty test set: a test loss of 0 every epoch): both stop after
    epoch 2 and number the last checkpoint alike."""
    (p_train, _), (j_train, _) = _fit_both(toy, tmp_path, "xla", epochs=5, test_set=False,
                                           early_stopping_limit=1)
    assert len(p_train) == len(j_train) == 2
    np.testing.assert_allclose(p_train, j_train, rtol=LOSS_RTOL)
    _assert_same_run(tmp_path)
    assert read_msgpack((tmp_path / "port/weights" / LAST_CHECKPOINT).read_bytes())["epoch"] == 3


def test_fit_refuses_an_existing_weights_folder(toy, tmp_path):
    pt, *_ = _pair(toy, "xla")
    (ptr, pte), _ = _loaders(toy, sender_view=False)
    (tmp_path / "w").mkdir()
    with pytest.raises(FileExistsError):
        pt.fit(ptr, pte, 1, tmp_path / "w", verbose=False)


def _poisoned(batch):
    """A copy of ``batch`` whose target is NaN everywhere."""
    import dataclasses

    return dataclasses.replace(batch, local_stress=np.full_like(
        np.asarray(batch.local_stress), np.nan))


def test_skip_nonfinite_matches_apply_if_finite(toy):
    """A good step, a step on a NaN target and a good step: the NaN step
    leaves params, moments and the step count as they were, exactly as
    optax's apply_if_finite, and both count it alike."""
    pt, jt, params, opt_state = _pair(toy, "xla", skip=True)
    port_ds, jax_ds = toy["train"]
    port_b = list(GraphLoader(port_ds.samples, 3, sender_view=False, device="cpu"))
    jax_b = list(JaxLoader(jax_ds.samples, 3, sender_view=False))
    seq = [(port_b[0], jax_b[0]), (_poisoned(port_b[1]), _poisoned(jax_b[1])),
           (port_b[1], jax_b[1])]
    named = dict(pt.model.named_parameters())

    def state():
        return [t.detach().clone() for p in named.values()
                for t in (p, *pt.optimizer.state[p].values())]

    for i, (pb, jb) in enumerate(seq):
        before = state()
        params, opt_state, j_aux = jt._train_step(params, opt_state, jb)
        p_aux = pt.train_step(pb)
        assert np.isfinite(float(p_aux["total"])) == np.isfinite(float(j_aux["total"])) == (i != 1)
        if i == 1:
            assert all(torch.equal(a, b) for a, b in zip(state(), before))
        for k in ("notfinite_count", "last_finite", "total_notfinite"):
            assert pt.nonfinite[k].item() == np.asarray(getattr(opt_state, k)).item(), (i, k)
        adam = opt_state.inner_state[0]
        assert int(pt.optimizer.state[named["processor.edge_w_u"]]["step"]) == int(adam.count)
        got, want = _leaves(params_to_jax(pt.model.state_dict())), _leaves(params)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=P_RTOL, atol=P_ATOL,
                                       err_msg=f"step {i} params {k}")
        # the moments carry the gradients' rounding differences: held at the
        # gradient tolerance of test_loss_gradient_matches_jax
        for state_key, ref in (("exp_avg", _leaves(adam.mu)), ("exp_avg_sq", _leaves(adam.nu))):
            got = _leaves(params_to_jax(
                {n: pt.optimizer.state[p][state_key] for n, p in named.items()}))
            for k in ref:
                np.testing.assert_allclose(got[k], ref[k], rtol=GRAD_TOL, atol=GRAD_TOL,
                                           err_msg=f"step {i} {state_key} {k}")


def test_nonfinite_abort_saves_the_last_checkpoint_first(toy, tmp_path):
    """Consecutive non-finite steps reaching half the give-up limit abort
    the run, after the last checkpoint is written with the (finite)
    parameters of before them."""
    pt, *_ = _pair(toy, "xla", skip=True, max_nonfinite=4)
    port_ds, _ = toy["train"]
    bad = [_poisoned(b) for b in GraphLoader(port_ds.samples, 3, sender_view=False,
                                             device="cpu")]
    before = {n: p.detach().clone() for n, p in pt.model.named_parameters()}
    with pytest.raises(RuntimeError, match="2 consecutive nonfinite"):
        pt.fit(bad, bad, 3, tmp_path / "w", verbose=False)
    state_dict, epoch, _ = load_checkpoint(tmp_path / "w" / LAST_CHECKPOINT)
    assert epoch == 1
    for n, t in state_dict.items():
        assert torch.equal(t, before[n]), n
    assert not (tmp_path / "w" / BEST_CHECKPOINT).exists()


def test_model_summary_matches_jax(toy):
    _, jt, params, _ = _pair(toy, "fused3")
    port = EncodeProcessDecode(latent_size=L, message_passing_steps=STEPS,
                               scatter_impl="fused3")
    assert model_summary(port) == jax_model_summary(jt.model, params)
