"""The port's training step against the JAX package's: from one JAX init
(through ``params_from_jax``) on array-equal batches, the whole model's loss
gradient (``xla`` and ``fused3``) against ``jax.grad`` of
``Trainer._loss_fn``, leaf by leaf, and three ``Trainer.train_step``s
against three JAX ``_train_step_impl`` steps. The JAX fused3 kernels run in
Pallas interpret mode, as the JAX package's own tests run them on the CPU.

Tolerances: gradients at the JAX package's fused3 gradient tolerance
(tests/test_fused3_op.py:87-95), rtol = atol = 2e-4 on each leaf
elementwise and ||got - want|| / ||want|| <= 2e-4 per leaf, and the
losses at rtol 1e-5. After three Adam steps (lr 1e-3) the parameters are
held at atol 1e-4 (a tenth of one step's size) + rtol 1e-5: Adam divides
each gradient entry by its own running RMS, so an entry whose gradient is
small carries the relative rounding difference of the two gradients into
its update at the full scale of lr."""

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from p_div_gnn_tpu.graphs.container import NormStats as JaxNormStats
from p_div_gnn_tpu.models import EncodeProcessDecode as JaxEPD
from p_div_gnn_tpu.train.loop import Trainer as JaxTrainer
from p_div_gnn_tpu_torch.graphs.container import NormStats
from p_div_gnn_tpu_torch.models.epd import EncodeProcessDecode
from p_div_gnn_tpu_torch.models.params import jax_path, params_from_jax, params_to_jax
from p_div_gnn_tpu_torch.train.loop import Trainer

from test_torch_port_model import STATS, _batches

L, STEPS, LAMBDA = 16, 2, 10.0


@pytest.fixture(scope="module")
def setup():
    _, host, ref = _batches((0, 1), n_graphs=3)
    params = JaxEPD(latent_size=L, message_passing_steps=STEPS).init(
        jax.random.PRNGKey(0), ref, JaxNormStats.from_dict(STATS))
    return host, ref, params


def _jax_trainer(impl):
    model = JaxEPD(latent_size=L, message_passing_steps=STEPS, scatter_impl=impl,
                   remat_steps=False)
    return JaxTrainer(model=model, stats=JaxNormStats.from_dict(STATS), learning_rate=1e-3,
                      divergence_penalty=LAMBDA, optimize_divergence=True)


def _port_trainer(params, impl, remat=False):
    model = EncodeProcessDecode(latent_size=L, message_passing_steps=STEPS,
                                scatter_impl=impl, remat_steps=remat)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return Trainer(model, NormStats.from_dict(STATS), learning_rate=1e-3,
                   divergence_penalty=LAMBDA, optimize_divergence=True, device="cpu")


def _leaves(tree):
    return {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_params_to_jax_inverts_params_from_jax(setup):
    _, _, params = setup
    state = params_from_jax(jax.tree.map(np.asarray, params))
    back = _leaves(params_to_jax(state))
    want = _leaves(params)
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    assert jax_path("processor.edge_w_u") == ("params", "processor", "edge_w_u")


@pytest.mark.parametrize("impl", ["xla", "fused3"])
def test_loss_gradient_matches_jax(setup, impl):
    host, ref, params = setup
    trainer = _jax_trainer(impl)
    with pltpu.force_tpu_interpret_mode():
        (want_total, _), want = jax.jit(
            jax.value_and_grad(trainer._loss_fn, has_aux=True))(params, ref)
    aux, grads = _port_trainer(params, impl).loss_and_grads(host.to("cpu"))
    np.testing.assert_allclose(float(aux["total"]), float(want_total), rtol=1e-5)
    got, want = _leaves(params_to_jax(grads)), _leaves(want)
    assert got.keys() == want.keys()
    # every leaf is far above the atol (the smallest leaf's largest entry
    # is ~3e-2 at this size), so the elementwise check bites on each; the
    # norm check holds each leaf as a whole, as chip_smoke.py's GRAD_RTOL
    smallest = min(want, key=lambda k: np.abs(want[k]).max())
    assert np.abs(want[smallest]).max() > 10 * 2e-4, (smallest, np.abs(want[smallest]).max())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-4, err_msg=k)
        rel = np.linalg.norm(got[k] - want[k]) / np.linalg.norm(want[k])
        assert rel <= 2e-4, (k, rel)


@pytest.mark.parametrize("impl", ["xla", "fused3"])
def test_three_adam_steps_match_jax(setup, impl):
    host, ref, params = setup
    trainer = _jax_trainer(impl)
    p, opt_state = jax.tree.map(jax.numpy.array, params), trainer.optimizer.init(params)
    step = jax.jit(trainer._train_step_impl)
    want_totals = []
    with pltpu.force_tpu_interpret_mode():
        for _ in range(3):
            p, opt_state, aux = step(p, opt_state, ref)
            want_totals.append(float(aux["total"]))
    port = _port_trainer(params, impl)
    port.init()
    batch = host.to("cpu")
    got_totals = [float(port.train_step(batch)["total"]) for _ in range(3)]
    np.testing.assert_allclose(got_totals, want_totals, rtol=1e-5)
    got, want = _leaves(params_to_jax(port.model.state_dict())), _leaves(p)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-4, err_msg=k)


def test_eval_step_matches_jax(setup):
    """NMSE and the monitored divergence of the current parameters, as the
    JAX ``_eval_metrics`` reports them (rtol 1e-5)."""
    host, ref, params = setup
    trainer = _jax_trainer("xla")
    trainer.monitor_divergence_in_test = True
    want = trainer._eval_step_impl(params, ref)
    port = _port_trainer(params, "xla")
    port.monitor_divergence_in_test = True
    got = port.eval_step(host.to("cpu"))
    assert set(got) == set(want) == {"nmse", "divergence", "total"}
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)


def test_trainer_defaults_to_cuda():
    """The training entry point runs on the card unless the caller asks for
    the CPU: a default Trainer moves its model to CUDA, which this CPU-only
    torch refuses."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    model = EncodeProcessDecode(latent_size=L, message_passing_steps=STEPS)
    with pytest.raises((RuntimeError, AssertionError)):
        Trainer(model, NormStats.from_dict(STATS))


def test_trainer_moves_host_batches_to_its_device(setup):
    """A host-packed (numpy) batch trains as the same batch moved by hand."""
    host, _, params = setup
    aux_host, g_host = _port_trainer(params, "xla").loss_and_grads(host)
    aux_moved, g_moved = _port_trainer(params, "xla").loss_and_grads(host.to("cpu"))
    assert float(aux_host["total"]) == float(aux_moved["total"])
    for k in g_moved:
        torch.testing.assert_close(g_host[k], g_moved[k], rtol=0, atol=0, msg=k)


def test_remat_steps_give_the_same_gradients(setup):
    """Rematerializing each step (torch.utils.checkpoint) recomputes the same
    forward, so the gradients are equal."""
    host, _, params = setup
    batch = host.to("cpu")
    _, plain = _port_trainer(params, "fused3", remat=False).loss_and_grads(batch)
    _, remat = _port_trainer(params, "fused3", remat=True).loss_and_grads(batch)
    for k in plain:
        torch.testing.assert_close(remat[k], plain[k], rtol=0, atol=0, msg=k)


def test_fused3_training_needs_the_sender_view(setup):
    """With grad mode on and no sender view the fused3 step raises instead
    of accumulating the sender gather's gradient in the stream dtype."""
    host, _, params = setup
    batch = host.to("cpu")
    batch.snd_perm = batch.snd_sorted = batch.snd_block_tile = None
    trainer = _port_trainer(params, "fused3")
    with pytest.raises(ValueError, match="sender view"):
        trainer.loss(batch)
    with torch.no_grad():
        trainer.eval_step(batch)
