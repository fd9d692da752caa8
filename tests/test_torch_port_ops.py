"""The port's tensor ops (p_div_gnn_tpu_torch.ops) against their JAX
counterparts on the same numpy inputs, and the fused edge-step wrapper's
dispatch: CPU tensors take the plain version, CUDA tensors the kernel or an
error, never a fallback. The kernel itself is tested on the card by
test_torch_port_cuda.py.

The JAX fused3 op runs as its own tests run it on the CPU (Pallas interpret
mode). Tolerances are the JAX package's own (tests/test_fused3_op.py:65-70
for fp32, :128 for bf16 streams)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from p_div_gnn_tpu.ops.fused_edge import lazy_layernorm_affine as jax_affine
from p_div_gnn_tpu.ops.fused_edge import moments_from_partials as jax_moments
from p_div_gnn_tpu.ops.fused_edge3 import fused_edge_step3 as jax_step3
from p_div_gnn_tpu.ops.layernorm import masked_graph_layernorm as jax_ln
from p_div_gnn_tpu.ops.segment import segment_sum as jax_segment_sum
from p_div_gnn_tpu_torch.graphs.container import NODE_TILE
from p_div_gnn_tpu_torch.ops import cuda_build, fused_edge3
from p_div_gnn_tpu_torch.ops.fused_edge import lazy_layernorm_affine, moments_from_partials
from p_div_gnn_tpu_torch.ops.gather import sender_gather_one
from p_div_gnn_tpu_torch.ops.layernorm import masked_graph_layernorm
from p_div_gnn_tpu_torch.ops.segment import segment_sum

from test_torch_port_cuda import _edge_problem

T = torch.from_numpy


@pytest.mark.parametrize("n_tiles", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_edge_step3_reference_matches_jax(dtype, n_tiles):
    arrays, idx = _edge_problem(11 + n_tiles, n_tiles, L=16)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    with pltpu.force_tpu_interpret_mode():
        ref = jax_step3(
            *(jnp.asarray(a).astype(jdt) for a in arrays.values()),
            jnp.asarray(idx["receivers"]),
            (jnp.asarray(idx["edge_gid"]), jnp.asarray(idx["block_tile"])), 1,
        )
    got = fused_edge3.fused_edge_step3(
        *(T(a).to(tdt) for a in arrays.values()), T(idx["receivers"]),
        (T(idx["edge_gid"]), T(idx["block_tile"])), 1, NODE_TILE,
    )
    assert got[0].dtype == tdt and got[1].dtype == got[2].dtype == torch.float32
    tols = (1e-5, 1e-4, 1e-3) if dtype == "float32" else (3e-2,) * 3
    for name, a, b, tol in zip(("z_upd", "R", "M"), got, ref, tols):
        np.testing.assert_allclose(
            a.float().numpy(), np.asarray(b.astype(jnp.float32)),
            rtol=tol, atol=tol, err_msg=name,
        )


def test_segment_sum_matches_jax():
    rng = np.random.default_rng(0)
    data = rng.normal(size=(300, 5)).astype(np.float32)
    ids = np.sort(rng.integers(0, 40, size=300)).astype(np.int32)
    got = segment_sum(T(data), T(ids), 40)
    ref = jax_segment_sum(jnp.asarray(data), jnp.asarray(ids), 40)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-5)


def test_masked_graph_layernorm_matches_jax():
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(64, 16)) * 3 + 1).astype(np.float32)
    mask = rng.random(64) > 0.3
    w = rng.normal(size=16).astype(np.float32)
    b = rng.normal(size=16).astype(np.float32)
    got = masked_graph_layernorm(T(x), T(mask), T(w), T(b))
    ref = jax_ln(jnp.asarray(x), jnp.asarray(mask), jnp.asarray(w), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    assert np.all(got.numpy()[~mask] == 0.0)


@pytest.mark.parametrize("constant", [False, True])
def test_lazy_layernorm_fold_matches_jax(constant):
    """moments_from_partials (with its 1e-12 variance floor, reached by a
    constant z) and lazy_layernorm_affine."""
    rng = np.random.default_rng(2)
    z = np.full((50, 8), 0.5, np.float32) if constant else rng.random((50, 8)).astype(np.float32)
    mask = rng.random(50) > 0.2
    z = z * mask[:, None]
    s, sq = z.sum(0), (z * z).sum(0)
    w = rng.normal(size=8).astype(np.float32)
    b = rng.normal(size=8).astype(np.float32)
    mean, std = moments_from_partials(T(s), T(sq), T(mask))
    jmean, jstd = jax_moments(jnp.asarray(s), jnp.asarray(sq), jnp.asarray(mask))
    np.testing.assert_allclose([float(mean), float(std)], [float(jmean), float(jstd)],
                               rtol=1e-5, atol=1e-6)
    alpha, beta = lazy_layernorm_affine(mean, std, T(w), T(b))
    jalpha, jbeta = jax_affine(jmean, jstd, jnp.asarray(w), jnp.asarray(b))
    np.testing.assert_allclose(alpha.numpy(), np.asarray(jalpha), rtol=1e-5)
    np.testing.assert_allclose(beta.numpy(), np.asarray(jbeta), rtol=1e-5, atol=1e-6)


def test_sender_gather_one_forward_is_row_gather():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(20, 4)).astype(np.float32)
    snd = rng.integers(0, 20, size=50).astype(np.int32)
    np.testing.assert_array_equal(sender_gather_one(T(x), T(snd)).numpy(),
                                  np.asarray(jnp.take(jnp.asarray(x), snd, axis=0)))


class _CudaStub:
    """Stands in for a CUDA tensor: the dispatch reads only ``.device``."""

    device = torch.device("cuda", 0)


def test_cuda_tensors_never_fall_back(monkeypatch, tmp_path):
    """With no nvcc the CUDA path raises; it never hands the call to the
    plain version, and the launch count does not move."""
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)

    def no_fallback(*args):
        raise AssertionError("CUDA tensors reached the plain version")

    monkeypatch.setattr(fused_edge3, "fused_edge_step3_reference", no_fallback)
    before = cuda_build.launches["fused_edge3_fwd"]
    stub = _CudaStub()
    with cuda_build.using(cuda_build.load_cuda_library), \
            pytest.raises(RuntimeError, match="nvcc not found"):
        fused_edge3.fused_edge_step3(*([stub] * 10), (stub, stub), 1, NODE_TILE)
    assert cuda_build.launches["fused_edge3_fwd"] == before


@pytest.mark.parametrize("device", ["meta", "mixed"])
def test_dispatch_rejects_other_devices(device):
    cpu = torch.zeros(4, 4)
    other = torch.zeros(4, 4, device="meta")
    if device == "meta":
        args = [other] * 10
    else:
        args = [cpu] * 9 + [_CudaStub()]
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_edge3.fused_edge_step3(*args, (cpu, cpu), 1, NODE_TILE)
