"""The port's Processor impls ``"fused"`` (v2), ``"pallas"`` and ``"hybrid"``
against the JAX model of the same impl: weights from a JAX init of that
impl go through ``params_from_jax`` (strict names) into the port, and both
packages see array-equal batches. The forward, the loss gradient leaf by
leaf (``jax.grad`` of ``Trainer._loss_fn``), three Adam steps of
``Trainer`` on ``"fused"``, and ``Predictor(scatter_impl="fused")`` on the
committed checkpoint. The JAX Pallas kernels run in interpret mode, as the
JAX package's own tests run them on the CPU.

Tolerances: the forward at the JAX package's fused-vs-xla tolerance
(tests/test_fused.py:34), rtol 2e-4 / atol 2e-5 on standardized outputs,
3e-2 for bf16 streams; gradients at its fused gradient tolerance
(tests/test_fused_op.py:116-120), rtol = atol = 2e-4 per leaf elementwise,
and ||got - want|| / ||want|| <= 2e-4 per leaf; losses at rtol 1e-5; after
three Adam steps the parameters at atol 1e-4 + rtol 1e-5, as
test_torch_port_train.py holds fused3."""

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from p_div_gnn_tpu.graphs.batching import unpack_predictions as jax_unpack
from p_div_gnn_tpu.graphs.container import NormStats as JaxNormStats
from p_div_gnn_tpu.models import EncodeProcessDecode as JaxEPD
from p_div_gnn_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from p_div_gnn_tpu.train.loop import Trainer as JaxTrainer
from p_div_gnn_tpu_torch.graphs.container import NormStats
from p_div_gnn_tpu_torch.inference import Predictor
from p_div_gnn_tpu_torch.models.epd import SCATTER_IMPLS, EncodeProcessDecode
from p_div_gnn_tpu_torch.models.params import params_from_jax, params_to_jax
from p_div_gnn_tpu_torch.train.loop import Trainer

from test_torch_port_model import ATOL, CKPT, RTOL, STATS, _batches

L, STEPS, LAMBDA = 16, 2, 10.0
IMPLS = ("fused", "pallas", "hybrid")
# the scatter_impl branches of the JAX Processor (p_div_gnn_tpu/models/epd.py:165-392)
JAX_SCATTER_IMPLS = ("xla", "pallas", "hybrid", "fused", "fused2", "fused3")


@pytest.fixture(scope="module")
def setup():
    _, host, ref = _batches((0, 1), n_graphs=3)
    return host, ref


def _jax_params(impl, ref):
    # remat off: the Pallas interpret mode does not run under JAX's remat
    model = JaxEPD(latent_size=L, message_passing_steps=STEPS, scatter_impl=impl,
                   remat_steps=False)
    return model.init(jax.random.PRNGKey(0), ref, JaxNormStats.from_dict(STATS))


def _port_model(params, impl, stream_dtype="float32", remat=False):
    model = EncodeProcessDecode(latent_size=L, message_passing_steps=STEPS, scatter_impl=impl,
                                stream_dtype=stream_dtype, remat_steps=remat)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)), strict=True)
    return model


def _leaves(tree):
    return {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_trainer(impl):
    model = JaxEPD(latent_size=L, message_passing_steps=STEPS, scatter_impl=impl,
                   remat_steps=False)
    return JaxTrainer(model=model, stats=JaxNormStats.from_dict(STATS), learning_rate=1e-3,
                      divergence_penalty=LAMBDA, optimize_divergence=True)


def _port_trainer(params, impl, remat=False):
    return Trainer(_port_model(params, impl, remat=remat), NormStats.from_dict(STATS),
                   learning_rate=1e-3, divergence_penalty=LAMBDA, optimize_divergence=True,
                   device="cpu")


def test_scatter_impls():
    """The port takes every scatter_impl of the JAX package, and refuses a
    name the JAX package does not have."""
    assert set(SCATTER_IMPLS) == set(JAX_SCATTER_IMPLS)
    for impl in SCATTER_IMPLS:
        model = EncodeProcessDecode(latent_size=L, message_passing_steps=1, scatter_impl=impl)
        assert model.processor.scatter_impl == impl
    with pytest.raises(ValueError, match="scatter_impl"):
        EncodeProcessDecode(latent_size=L, message_passing_steps=1, scatter_impl="fused4")


@pytest.mark.parametrize("impl,stream_dtype", [
    ("fused", "float32"), ("fused", "bfloat16"), ("pallas", "float32"), ("hybrid", "float32")])
def test_forward_matches_jax(setup, impl, stream_dtype):
    """A JAX model of the impl, initialised by JAX: its parameter tree loads
    into the port's model of the same impl and gives the same output."""
    host, ref = setup
    jstats = JaxNormStats.from_dict(STATS)
    params = _jax_params(impl, ref)
    jmodel = JaxEPD(latent_size=L, message_passing_steps=STEPS, scatter_impl=impl,
                    stream_dtype=stream_dtype, remat_steps=False)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jmodel.apply(params, ref, jstats, scale_output=False))
    model = _port_model(params, impl, stream_dtype).eval()
    with torch.no_grad():
        got = model(host.to("cpu"), NormStats.from_dict(STATS), scale_output=False).numpy()
    real = host.node_gid < host.n_graphs
    tol = dict(rtol=RTOL, atol=ATOL) if stream_dtype == "float32" else dict(rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(got[real], want[real], **tol)
    assert np.all(np.isfinite(got))


@pytest.mark.parametrize("impl", IMPLS)
def test_loss_gradient_matches_jax(setup, impl):
    host, ref = setup
    params = _jax_params(impl, ref)
    with pltpu.force_tpu_interpret_mode():
        (want_total, _), want = jax.jit(
            jax.value_and_grad(_jax_trainer(impl)._loss_fn, has_aux=True))(params, ref)
    aux, grads = _port_trainer(params, impl).loss_and_grads(host.to("cpu"))
    np.testing.assert_allclose(float(aux["total"]), float(want_total), rtol=1e-5)
    got, want = _leaves(params_to_jax(grads)), _leaves(want)
    assert got.keys() == want.keys()
    # the elementwise check bites on every leaf: each leaf's largest entry
    # is far above the atol
    smallest = min(want, key=lambda k: np.abs(want[k]).max())
    assert np.abs(want[smallest]).max() > 10 * 2e-4, (smallest, np.abs(want[smallest]).max())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-4, err_msg=k)
        rel = np.linalg.norm(got[k] - want[k]) / np.linalg.norm(want[k])
        assert rel <= 2e-4, (k, rel)


def test_three_adam_steps_match_jax(setup):
    host, ref = setup
    params = _jax_params("fused", ref)
    trainer = _jax_trainer("fused")
    p, opt_state = jax.tree.map(jax.numpy.array, params), trainer.optimizer.init(params)
    step = jax.jit(trainer._train_step_impl)
    want_totals = []
    with pltpu.force_tpu_interpret_mode():
        for _ in range(3):
            p, opt_state, aux = step(p, opt_state, ref)
            want_totals.append(float(aux["total"]))
    port = _port_trainer(params, "fused")
    port.init()
    batch = host.to("cpu")
    got_totals = [float(port.train_step(batch)["total"]) for _ in range(3)]
    np.testing.assert_allclose(got_totals, want_totals, rtol=1e-5)
    got, want = _leaves(params_to_jax(port.model.state_dict())), _leaves(p)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-4, err_msg=k)


def test_fused_remat_gives_the_same_gradients(setup):
    """Rematerializing each "fused" step recomputes the same forward, so the
    gradients are equal."""
    host, ref = setup
    params = _jax_params("fused", ref)
    batch = host.to("cpu")
    _, plain = _port_trainer(params, "fused").loss_and_grads(batch)
    _, remat = _port_trainer(params, "fused", remat=True).loss_and_grads(batch)
    for k in plain:
        torch.testing.assert_close(remat[k], plain[k], rtol=0, atol=0, msg=k)


def test_fused_training_needs_the_sender_view(setup):
    """Without the sender view the "fused" step raises under grad instead
    of accumulating the gathers' gradient with index_add_; it still
    evaluates."""
    host, ref = setup
    batch = host.to("cpu")
    batch.snd_perm = batch.snd_sorted = batch.snd_block_tile = None
    trainer = _port_trainer(_jax_params("fused", ref), "fused")
    with pytest.raises(ValueError, match="sender view"):
        trainer.loss(batch)
    with torch.no_grad():
        trainer.eval_step(batch)


def test_fused_rejects_another_node_tile(setup):
    host, ref = setup
    batch = host.to("cpu")
    batch.tile = 128
    model = _port_model(_jax_params("fused", ref), "fused")
    with pytest.raises(ValueError, match="NODE_TILE"), torch.no_grad():
        model(batch, NormStats.from_dict(STATS))


def test_predictor_fused_with_checkpoint_matches_jax():
    """Serving through "fused": the committed checkpoint at full width
    (L=128, 10 steps) on small meshes, the port's Predictor on the CPU
    against the JAX "fused" forward with the same weights and stats, per
    mesh in original node order."""
    samples, _, ref = _batches((0, 1), n_graphs=2)
    got = Predictor(CKPT, scatter_impl="fused", device="cpu").predict(samples)
    jmodel = JaxEPD(latent_size=128, message_passing_steps=10, scatter_impl="fused",
                    remat_steps=False)
    template = jmodel.init(jax.random.PRNGKey(0), ref, JaxNormStats.ones())
    params, _, _, jstats = jax_load_checkpoint(CKPT, template)
    with pltpu.force_tpu_interpret_mode():
        want = jax_unpack(ref, np.asarray(jmodel.apply(params, ref, jstats)))
    mean, std = float(jstats.mean_local_stress), float(jstats.std_local_stress)
    assert len(got) == len(want) == len(samples)
    for a, b, s in zip(got, want, samples):
        assert a.shape == (s.num_nodes, 3)
        np.testing.assert_allclose((a - mean) / std, (np.asarray(b) - mean) / std,
                                   rtol=RTOL, atol=ATOL)
