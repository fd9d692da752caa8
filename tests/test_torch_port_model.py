"""The port's model, weights bridge, checkpoint reader and Predictor against
the JAX package: JAX-initialised params go through ``params_from_jax`` into
the port, and both packages' ``EncodeProcessDecode`` forwards see the same
(array-equal) batch. The JAX fused3 path runs in Pallas interpret mode, as
its own tests run it on the CPU.

Tolerance: the JAX package's own fused3-vs-xla forward tolerance
(tests/test_fused.py:34), rtol 2e-4 / atol 2e-5 on standardized outputs;
3e-2 (its bf16 op tolerance) for bf16 streams."""

import dataclasses
from pathlib import Path

import flax.serialization
import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from p_div_gnn_tpu.graphs.batching import pack_batch as jax_pack_batch
from p_div_gnn_tpu.graphs.batching import unpack_predictions as jax_unpack
from p_div_gnn_tpu.graphs.container import NormStats as JaxNormStats
from p_div_gnn_tpu.models import EncodeProcessDecode as JaxEPD
from p_div_gnn_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from p_div_gnn_tpu_torch.graphs.batching import pack_batch
from p_div_gnn_tpu_torch.graphs.container import NormStats
from p_div_gnn_tpu_torch.inference import Predictor
from p_div_gnn_tpu_torch.models.epd import EncodeProcessDecode
from p_div_gnn_tpu_torch.models.params import params_from_jax
from p_div_gnn_tpu_torch.train.checkpoint import load_checkpoint, read_msgpack

from test_torch_port_graphs import _port_sample, _to_jax_sample

CKPT = Path(__file__).resolve().parents[1] / "checkpoints/elast_200e_div/model_weights.ckpt"
RTOL, ATOL = 2e-4, 2e-5
STATS = dict(mean_pos=50.0, std_pos=30.0, mean_mean_stress=0.1, std_mean_stress=2.0,
             mean_local_stress=0.05, std_local_stress=1.5, mean_edge_weight=20.0,
             std_edge_weight=8.0)


def _batches(seeds, n_graphs):
    samples = [_port_sample(s) for s in seeds]
    host = pack_batch(samples, n_graphs=n_graphs, reorder="rcm")
    ref = jax_pack_batch([_to_jax_sample(s) for s in samples], n_graphs=n_graphs,
                         reorder="rcm")
    return samples, host, ref


def _port_model(params, impl, stream_dtype="float32", latent=16, steps=2):
    model = EncodeProcessDecode(latent_size=latent, message_passing_steps=steps,
                                scatter_impl=impl, stream_dtype=stream_dtype)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return model.eval()


@pytest.mark.parametrize(
    "impl,stream_dtype", [("xla", "float32"), ("fused3", "float32"), ("fused3", "bfloat16")]
)
def test_forward_matches_jax_from_jax_init(impl, stream_dtype):
    _, host, ref = _batches((0, 1), n_graphs=3)
    jstats = JaxNormStats.from_dict(STATS)
    jmodel = JaxEPD(latent_size=16, message_passing_steps=3, scatter_impl=impl,
                    stream_dtype=stream_dtype, remat_steps=False)
    params = JaxEPD(latent_size=16, message_passing_steps=3).init(
        jax.random.PRNGKey(0), ref, jstats)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jmodel.apply(params, ref, jstats, scale_output=False))
    model = _port_model(params, impl, stream_dtype, steps=3)
    with torch.no_grad():
        got = model(host.to("cpu"), NormStats.from_dict(STATS), scale_output=False).numpy()
    real = host.node_gid < host.n_graphs
    tol = dict(rtol=RTOL, atol=ATOL) if stream_dtype == "float32" else dict(rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(got[real], want[real], **tol)
    assert np.all(np.isfinite(got))


def test_zero_mean_stress_gives_zero_field():
    samples = [dataclasses.replace(_port_sample(2), mean_stress=np.zeros(3, np.float32))]
    host = pack_batch(samples)
    model = EncodeProcessDecode(latent_size=16, message_passing_steps=1)
    with torch.no_grad():
        out = model(host.to("cpu"), NormStats.from_dict(STATS))
    assert out.shape == (host.num_nodes_padded, 3) and not out.any()


def test_checkpoint_reader_matches_flax():
    """Every leaf of the committed checkpoint decodes array-equal to
    flax.serialization.msgpack_restore (dtype, shape, values), and the
    state_dict loads into the flagship model with strict names."""
    raw = CKPT.read_bytes()
    got, ref = read_msgpack(raw), flax.serialization.msgpack_restore(raw)

    def same(a, b, path):
        if isinstance(b, dict):
            assert isinstance(a, dict) and set(a) == set(b), path
            for k in b:
                same(a[k], b[k], f"{path}/{k}")
        elif isinstance(b, np.ndarray):
            assert isinstance(a, np.ndarray) and a.dtype == b.dtype, path
            np.testing.assert_array_equal(a, b, err_msg=path)
        else:
            assert type(a) is type(b) and a == b, path

    same(got, ref, "")
    state_dict, epoch, stats = load_checkpoint(CKPT)
    assert epoch == ref["epoch"] and dataclasses.asdict(stats) == ref["stats"]
    EncodeProcessDecode(latent_size=128).load_state_dict(state_dict, strict=True)


@pytest.mark.parametrize("impl", ["xla", "fused3"])
def test_predictor_with_checkpoint_matches_jax(impl):
    """The committed checkpoint at full width (L=128, 10 steps) on small
    meshes: the port's Predictor on the CPU against the JAX forward with
    the same weights and stats, per mesh in original node order."""
    samples, _, ref = _batches((0, 1), n_graphs=2)
    got = Predictor(CKPT, scatter_impl=impl, device="cpu").predict(samples)

    jmodel = JaxEPD(latent_size=128, message_passing_steps=10, scatter_impl=impl,
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


def test_predictor_defaults_to_cuda():
    """Entry points run on the card unless the caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        Predictor(CKPT)
