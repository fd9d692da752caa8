"""The committed checkpoints served by the port's ``Predictor`` on the CPU (the plain ``"xla"`` path, fp32) against the JAX model with the
same weights and stats, as ``test_torch_port_model.py::
test_predictor_with_checkpoint_matches_jax`` holds ``elast_200e_div``: full
width (L=128, 10 steps) on small meshes, per mesh in original node order,
at rtol 2e-4 / atol 2e-5 on standardized outputs. Both files of each
checkpoint are held (``model_weights.ckpt``, the best epoch, and
``last_epoch_model_weights.ckpt``, which five of the six committed
inference configs in ``scripts/configs_inference/`` load), except
``elast_200e_div/model_weights.ckpt``, which that test holds.
``elast_200e_no_periodic``
is served on graphs without periodic edges, as its config
(``periodic_graph: False``) trains and infers it.

The JAX model runs in float64 (``jax.enable_x64``, weights and batch cast
up): the trained weights amplify fp32 rounding, and the JAX package's own
fp32 forward on the CPU is 2.34 of this allowance from its float64 forward
on ``hyperelast_200e_div`` (the port's fp32 forward is 0.17 of it)."""

import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from p_div_gnn_tpu.graphs.batching import pack_batch as jax_pack_batch
from p_div_gnn_tpu.graphs.batching import unpack_predictions as jax_unpack
from p_div_gnn_tpu.graphs.container import NormStats as JaxNormStats
from p_div_gnn_tpu.models import EncodeProcessDecode as JaxEPD
from p_div_gnn_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from p_div_gnn_tpu_torch.graphs.build import mesh_to_graph
from p_div_gnn_tpu_torch.inference import Predictor

from test_torch_port_graphs import _port_sample, _to_jax_sample

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 2e-4, 2e-5
CHECKPOINTS = ("elast_200e_no_div", "elast_200e_no_periodic", "elast_200e_div_bf16",
               "hyperelast_200e_div", "hyperelast_200e_no_div")
FILES = ("model_weights.ckpt", "last_epoch_model_weights.ckpt")
SERVED = [(name, f) for name in CHECKPOINTS for f in FILES] + [
    ("elast_200e_div", "last_epoch_model_weights.ckpt")]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_every_served_checkpoint_file_is_held():
    """Each file a committed inference config loads is one of ``SERVED``
    or the one ``test_torch_port_model.py`` holds."""
    named = {Path(line.split(":", 1)[1].strip()).name
             for cfg in (ROOT / "scripts/configs_inference").glob("*.yml")
             for line in cfg.read_text().splitlines() if line.startswith("model_weights_path:")}
    assert named and named <= set(FILES)
    held = set(SERVED) | {("elast_200e_div", "model_weights.ckpt")}
    assert held == {(n, f) for n in CHECKPOINTS + ("elast_200e_div",) for f in FILES}


@pytest.mark.parametrize("name,filename", SERVED,
                         ids=[f"{n}-{f.split('.')[0]}" for n, f in SERVED])
def test_predictor_with_committed_checkpoint_matches_jax(name, filename):
    ckpt = ROOT / "checkpoints" / name / filename
    samples = [_port_sample(s) for s in (0, 1)]
    if name == "elast_200e_no_periodic":
        samples = [dataclasses.replace(s, graph=mesh_to_graph_of(s)) for s in samples]
        assert not any(s.graph.is_periodic for s in samples)
    got = Predictor(ckpt, scatter_impl="xla", device="cpu").predict(samples)

    ref = jax_pack_batch([_to_jax_sample(s) for s in samples], n_graphs=2, reorder="rcm")
    jmodel = JaxEPD(latent_size=128, message_passing_steps=10, remat_steps=False)
    template = jmodel.init(jax.random.PRNGKey(0), ref, JaxNormStats.ones())
    params, _, _, jstats = jax_load_checkpoint(ckpt, template)
    with jax.enable_x64():
        up = lambda x: np.asarray(x, np.float64) if np.asarray(x).dtype == np.float32 else x  # noqa: E731
        out = jmodel.apply(jax.tree.map(up, params), jax.tree.map(up, ref), jstats)
        assert out.dtype == np.float64
        want = jax_unpack(ref, np.asarray(out))
    mean, std = float(jstats.mean_local_stress), float(jstats.std_local_stress)
    assert len(got) == len(want) == len(samples)
    for a, b, s in zip(got, want, samples):
        assert a.shape == (s.num_nodes, 3) and np.isfinite(a).all()
        np.testing.assert_allclose((a - mean) / std, (np.asarray(b) - mean) / std,
                                   rtol=RTOL, atol=ATOL)


def mesh_to_graph_of(sample):
    """The sample's mesh graph without the periodic edges: the graph
    ``mesh_to_graph`` builds from its faces."""
    from p_div_gnn_tpu_torch.graphs.meshio import SurfaceMesh

    g = sample.graph
    return mesh_to_graph(SurfaceMesh(points=g.pos, faces=g.faces))
