"""The training slice's ops against the JAX package on the same numpy inputs:
the fused3 edge step's gradient (the port's ``autograd.Function`` with its
plain backward against ``jax.grad`` of the JAX ``fused_edge_step3``, whose
VJP is the Pallas kernel ``_step3_bwd_kernel``), the block-CSR segment sum
against ``pallas_segment_sum``, and the sender gather's gradient against
the JAX ``sender_gather_one`` VJP. The JAX kernels run as the JAX
package's own tests run them on the CPU (Pallas interpret mode). Also the
dispatch of the CUDA backward wrappers: a CUDA tensor reaches a kernel or
an error, never a plain version.

Tolerances are the JAX package's own (tests/test_fused3_op.py:87-95 for
the fp32 step gradients, :128-131 for the segment sum and the gather's
gradient; 3e-2 for bf16 streams), as rtol = atol."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from p_div_gnn_tpu.ops.fused_edge3 import fused_edge_step3 as jax_step3
from p_div_gnn_tpu.ops.gather import sender_gather_one as jax_sender_gather_one
from p_div_gnn_tpu.ops.scatter_pallas import pallas_segment_sum
from p_div_gnn_tpu_torch.graphs.batching import build_sender_view
from p_div_gnn_tpu_torch.graphs.container import NODE_TILE
from p_div_gnn_tpu_torch.ops import cuda_build, fused_edge3, scatter_csr
from p_div_gnn_tpu_torch.ops.gather import sender_gather_one
from p_div_gnn_tpu_torch.ops.scatter_csr import csr_segment_sum

from test_torch_port_cuda import _edge_problem
from test_torch_port_ops import _CudaStub

T = torch.from_numpy
NAMES = ("x", "g_x", "e", "w_u", "w_v", "w_e", "b0", "w2", "b2")
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _cotangents(seed, Ep, Np, L):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(Ep, L)).astype(np.float32),
            rng.normal(size=(Np, L)).astype(np.float32),
            rng.normal(size=(8, L)).astype(np.float32))


@pytest.mark.parametrize("n_tiles", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_edge_step3_grads_match_jax(dtype, n_tiles):
    """Every input and weight, with nonzero cotangents on z_upd, R and M
    (the moment rows included), over one and three node tiles; the edge
    problem holds padding slots, whose gradient the re-masking keeps out."""
    jdt, tdt, tol = DTYPES[dtype]
    arrays, idx = _edge_problem(21 + n_tiles, n_tiles, L=16)
    Np, L = arrays["x"].shape
    Ep = arrays["g_x"].shape[0]
    cz, cr, cm = _cotangents(7, Ep, Np, L)
    rcv = jnp.asarray(idx["receivers"])
    aux = (jnp.asarray(idx["edge_gid"]), jnp.asarray(idx["block_tile"]))

    def jax_loss(args):
        with pltpu.force_tpu_interpret_mode():
            z, r, m = jax_step3(*args, rcv, aux, 1)
        return (jnp.sum(z.astype(jnp.float32) * cz) + jnp.sum(r * cr) + jnp.sum(m * cm))

    want = jax.grad(jax_loss)(tuple(jnp.asarray(a).astype(jdt) for a in arrays.values()))

    args = [T(a).to(tdt).requires_grad_() for a in arrays.values()]
    z, r, m = fused_edge3.fused_edge_step3(
        *args, T(idx["receivers"]), (T(idx["edge_gid"]), T(idx["block_tile"])), 1, NODE_TILE)
    (z.float() * T(cz)).sum().add((r * T(cr)).sum()).add((m * T(cm)).sum()).backward()
    for name, a, b in zip(NAMES, args, want):
        assert a.grad.dtype == tdt, name
        np.testing.assert_allclose(a.grad.float().numpy(), np.asarray(b.astype(jnp.float32)),
                                   rtol=tol, atol=tol, err_msg=f"grad {name}")


def test_backward_reference_is_the_autograd_backward():
    """The plain backward returns what the autograd Function hands back, in
    fp32, with dg and de in the stream dtype."""
    arrays, idx = _edge_problem(4, 1, L=8)
    args = [T(a) for a in arrays.values()]
    rcv, gid, bt = (T(idx[k]) for k in ("receivers", "edge_gid", "block_tile"))
    z, _, _ = fused_edge3.fused_edge_step3_reference(*args, rcv, gid, 1)
    Np, L = args[0].shape
    cz, cr, cm = (T(c) for c in _cotangents(3, z.shape[0], Np, L))
    got = fused_edge3.fused_edge_step3_backward(*args, rcv, (gid, bt), 1, NODE_TILE,
                                                z, cz, cr, cm)
    assert [g.shape for g in got] == [a.shape for a in args]
    assert all(g.dtype == torch.float32 for g in got)


def _csr_case(seed, n_tiles, L, E):
    """Rows in a sender view over random senders, and the permuted source
    stream (the sender gather's cotangent)."""
    rng = np.random.default_rng(seed)
    num_nodes = n_tiles * NODE_TILE
    snd = rng.integers(0, num_nodes, size=E)
    perm, srt, sbt = build_sender_view(snd, num_nodes)
    src = rng.normal(size=(E, L)).astype(np.float32)
    return num_nodes, snd, perm, srt, sbt, src


@pytest.mark.parametrize("n_tiles", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_csr_segment_sum_matches_pallas(dtype, n_tiles):
    """The plain csr_segment_sum on the sender view (receiver −1 on its
    padding slots) against pallas_segment_sum, and its gradient (a gather)
    against the JAX VJP on the real slots. On a −1 slot the port's gradient
    is 0, since the row adds nothing; the JAX VJP's ``jnp.take`` reads
    the last node's cotangent there (a negative index wraps)."""
    jdt, tdt, _ = DTYPES[dtype]
    tol = 1e-4 if dtype == "float32" else 3e-2
    num_nodes, _, perm, srt, sbt, src = _csr_case(5 + n_tiles, n_tiles, 8, 5 * 256 * n_tiles)
    rows = src[perm]
    assert (srt == -1).any()
    ct = np.random.default_rng(1).normal(size=(num_nodes, 8)).astype(np.float32)

    def jax_fn(m):
        with pltpu.force_tpu_interpret_mode():
            return pallas_segment_sum(m, jnp.asarray(srt), jnp.asarray(sbt), num_nodes)

    jrows = jnp.asarray(rows).astype(jdt)
    want = jax_fn(jrows)
    want_grad = jax.grad(lambda m: jnp.sum(jax_fn(m) * ct))(jrows)

    trows = T(rows).to(tdt).requires_grad_()
    got = csr_segment_sum(trows, T(srt), T(sbt), num_nodes, NODE_TILE)
    (got * T(ct)).sum().backward()
    assert got.dtype == torch.float32 and got.shape == (num_nodes, 8)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)
    real = srt >= 0
    np.testing.assert_allclose(trows.grad.float().numpy()[real],
                               np.asarray(want_grad.astype(jnp.float32))[real],
                               rtol=tol, atol=tol)
    assert not trows.grad[T(~real)].any()


def test_csr_segment_sum_perm_reads_permuted_rows():
    """With perm the sum reads rows[perm[s]]: the same as permuting first,
    and the gradient flows back to the source rows."""
    num_nodes, snd, perm, srt, sbt, src = _csr_case(2, 2, 4, 1500)
    direct = csr_segment_sum(T(src[perm]), T(srt), T(sbt), num_nodes, NODE_TILE)
    s = T(src).requires_grad_()
    folded = csr_segment_sum(s, T(srt), T(sbt), num_nodes, NODE_TILE, perm=T(perm))
    torch.testing.assert_close(folded, direct, rtol=0, atol=0)
    folded.sum().backward()
    torch.testing.assert_close(s.grad, torch.ones_like(s), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sender_gather_one_grad_matches_jax(dtype):
    """The gather's backward (permute into the sender view, block-CSR sum,
    cast to x's dtype) against the JAX VJP; two calls are bit-equal."""
    jdt, tdt, _ = DTYPES[dtype]
    tol = 1e-4 if dtype == "float32" else 3e-2
    rng = np.random.default_rng(3)
    num_nodes = 2 * NODE_TILE
    E = 5 * num_nodes
    snd = rng.integers(0, num_nodes, size=E)
    view = build_sender_view(snd, num_nodes)
    x = rng.normal(size=(num_nodes, 8)).astype(np.float32)
    ct = rng.normal(size=(E, 8)).astype(np.float32)

    def jax_fn(xx):
        with pltpu.force_tpu_interpret_mode():
            out = jax_sender_gather_one(xx, jnp.asarray(snd), *(jnp.asarray(v) for v in view),
                                        num_nodes)
        return jnp.sum(out.astype(jnp.float32) * ct)

    want = jax.grad(jax_fn)(jnp.asarray(x).astype(jdt))

    def port_grad():
        xt = T(x).to(tdt).requires_grad_()
        out = sender_gather_one(xt, T(snd.astype(np.int32)), tuple(T(v) for v in view),
                                NODE_TILE)
        (out.float() * T(ct)).sum().backward()
        return xt.grad

    g1, g2 = port_grad(), port_grad()
    assert g1.dtype == tdt
    np.testing.assert_allclose(g1.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    assert torch.equal(g1, g2)


def test_sender_gather_without_view_refuses_gradients():
    x = torch.zeros(4, 2, requires_grad=True)
    snd = torch.tensor([0, 1, 3], dtype=torch.int32)
    with pytest.raises(ValueError, match="sender view"):
        sender_gather_one(x, snd)
    with torch.no_grad():
        assert sender_gather_one(x, snd).shape == (3, 2)


def _no_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)


def test_backward_cuda_tensors_never_fall_back(monkeypatch, tmp_path):
    """With no nvcc the CUDA backward raises; it never hands the call to
    the plain backward, and its launch count does not move."""
    _no_nvcc(monkeypatch, tmp_path)

    def no_fallback(*args):
        raise AssertionError("CUDA tensors reached the plain backward")

    monkeypatch.setattr(fused_edge3, "fused_edge_step3_backward_reference", no_fallback)
    before = cuda_build.launches["fused_edge3_bwd"]
    stub = _CudaStub()
    with cuda_build.using(cuda_build.load_cuda_library), \
            pytest.raises(RuntimeError, match="nvcc not found"):
        fused_edge3.fused_edge_step3_backward(
            *([stub] * 10), (stub, stub), 1, NODE_TILE, *([stub] * 4))
    assert cuda_build.launches["fused_edge3_bwd"] == before


def test_segment_sum_cuda_tensors_never_fall_back(monkeypatch, tmp_path):
    _no_nvcc(monkeypatch, tmp_path)

    def no_fallback(*args, **kwargs):
        raise AssertionError("CUDA tensors reached the plain segment sum")

    monkeypatch.setattr(scatter_csr, "csr_segment_sum_reference", no_fallback)
    before = cuda_build.launches["segment_sum_csr"]
    stub = _CudaStub()
    with cuda_build.using(cuda_build.load_cuda_library), \
            pytest.raises(RuntimeError, match="nvcc not found"):
        scatter_csr._segment_sum_dispatch(stub, stub, stub, 256, NODE_TILE, stub)
    assert cuda_build.launches["segment_sum_csr"] == before


@pytest.mark.parametrize("op", ["backward", "segment_sum"])
def test_backward_dispatch_rejects_mixed_devices(op):
    cpu = torch.zeros(4, 4)
    if op == "backward":
        with pytest.raises(ValueError, match="cuda or cpu"):
            fused_edge3.fused_edge_step3_backward(
                *([cpu] * 9), _CudaStub(), (cpu, cpu), 1, NODE_TILE, *([cpu] * 4))
    else:
        with pytest.raises(ValueError, match="cuda or cpu"):
            scatter_csr._segment_sum_dispatch(cpu, _CudaStub(), cpu, 256, NODE_TILE, None)
