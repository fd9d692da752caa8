"""The v2 ("fused") slice's ops against the JAX package on the same numpy
inputs: the v2 edge step (forward and VJP, the port's ``autograd.Function``
with its plain versions against JAX ``fused_edge_step``, whose forward and
VJP are the Pallas kernels ``_step_kernel`` and ``_step_bwd_kernel``), the
pair segment sum against ``pallas_segment_sum_pair`` (``_kernel_pair``),
the pair sender gather's forward and VJP against JAX
``sender_gather_pair``, and ``scatter_add(impl="pallas")`` against JAX
``scatter_add``. The JAX kernels run as the JAX package's own tests run
them on the CPU (Pallas interpret mode). Also the dispatch of the new CUDA
wrappers: a CUDA tensor reaches a kernel or an error, never a plain version.

Tolerances are the JAX package's own, as rtol = atol: the v2 op
(tests/test_fused_op.py:86-91 forward, :116-120 gradients), 3e-2 for bf16
streams (tests/test_fused3_op.py:128), 1e-4 for the segment sums and the
gathers' gradients (:128-131)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from p_div_gnn_tpu.ops.fused_edge import fused_edge_step as jax_step
from p_div_gnn_tpu.ops.gather import sender_gather_pair as jax_sender_gather_pair
from p_div_gnn_tpu.ops.scatter import scatter_add as jax_scatter_add
from p_div_gnn_tpu.ops.scatter_pallas import pallas_segment_sum_pair
from p_div_gnn_tpu_torch.graphs.batching import build_sender_view
from p_div_gnn_tpu_torch.graphs.container import NODE_TILE
from p_div_gnn_tpu_torch.ops import cuda_build, fused_edge, scatter_csr
from p_div_gnn_tpu_torch.ops.gather import sender_gather_pair
from p_div_gnn_tpu_torch.ops.scatter import scatter_add
from p_div_gnn_tpu_torch.ops.scatter_csr import csr_segment_sum_pair

from test_torch_port_cuda import _edge_problem, _v2_problem
from test_torch_port_ops import _CudaStub

T = torch.from_numpy
NAMES = ("a_u", "a_v", "g_v", "g_u", "e", "w_e", "b0", "w2", "b2")
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
FWD_TOL = {"float32": (1e-5, 1e-4, 1e-3), "bfloat16": (3e-2,) * 3}
GRAD_TOL = {"float32": 2e-4, "bfloat16": 3e-2}


def _jax_args(arrays, idx, jdt):
    args = tuple(jnp.asarray(a).astype(jdt) for a in arrays.values())
    aux = (jnp.asarray(idx["edge_gid"]), jnp.asarray(idx["block_tile"]))
    return args, jnp.asarray(idx["receivers"]), aux


def _port_idx(idx):
    return T(idx["receivers"]), (T(idx["edge_gid"]), T(idx["block_tile"]))


@pytest.mark.parametrize("n_tiles", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_edge_step_matches_jax(dtype, n_tiles):
    """z_upd, R and M over one and three node tiles, with padding slots."""
    jdt, tdt = DTYPES[dtype]
    arrays, idx = _v2_problem(11 + n_tiles, n_tiles, L=16)
    args, rcv, aux = _jax_args(arrays, idx, jdt)
    with pltpu.force_tpu_interpret_mode():
        want = jax_step(*args, rcv, aux, 1)
    got = fused_edge.fused_edge_step(*(T(a).to(tdt) for a in arrays.values()),
                                     *_port_idx(idx), 1, NODE_TILE)
    assert got[0].dtype == tdt and got[1].dtype == got[2].dtype == torch.float32
    for name, a, b, tol in zip(("z_upd", "R", "M"), got, want, FWD_TOL[dtype]):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b.astype(jnp.float32)),
                                   rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("n_tiles", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_edge_step_grads_match_jax(dtype, n_tiles):
    """Every input and weight, with nonzero cotangents on z_upd, R and M
    (the moment rows included); each gradient comes back in its input's
    dtype, as the JAX VJP returns it."""
    jdt, tdt = DTYPES[dtype]
    arrays, idx = _v2_problem(21 + n_tiles, n_tiles, L=16)
    Np, L = arrays["a_u"].shape
    Ep = arrays["g_v"].shape[0]
    rng = np.random.default_rng(7)
    cz, cr, cm = (rng.normal(size=s).astype(np.float32) for s in ((Ep, L), (Np, L), (8, L)))
    args, rcv, aux = _jax_args(arrays, idx, jdt)

    def jax_loss(a):
        with pltpu.force_tpu_interpret_mode():
            z, r, m = jax_step(*a, rcv, aux, 1)
        return jnp.sum(z.astype(jnp.float32) * cz) + jnp.sum(r * cr) + jnp.sum(m * cm)

    want = jax.grad(jax_loss)(args)
    targs = [T(a).to(tdt).requires_grad_() for a in arrays.values()]
    z, r, m = fused_edge.fused_edge_step(*targs, *_port_idx(idx), 1, NODE_TILE)
    ((z.float() * T(cz)).sum() + (r * T(cr)).sum() + (m * T(cm)).sum()).backward()
    tol = GRAD_TOL[dtype]
    for name, a, b in zip(NAMES, targs, want):
        assert a.grad.dtype == tdt == a.dtype, name
        np.testing.assert_allclose(a.grad.float().numpy(), np.asarray(b.astype(jnp.float32)),
                                   rtol=tol, atol=tol, err_msg=f"grad {name}")


def test_backward_reference_is_the_autograd_backward():
    """The plain backward returns one gradient per input, in the order
    (a_u, a_v, g_v, g_u, e, w_e, b0, w2, b2): dg_v, dg_u and de in the
    stream dtype, the rest fp32; dg_v and dg_u are dpre1 and dpre2, zero on
    the padding slots."""
    arrays, idx = _v2_problem(4, 3, L=8)
    args = [T(a).to(torch.bfloat16) for a in arrays.values()]
    rcv, (gid, bt) = _port_idx(idx)
    z, _, _ = fused_edge.fused_edge_step_reference(*args, rcv, gid, 1)
    rng = np.random.default_rng(3)
    Np, L = args[0].shape
    dz = T(rng.normal(size=z.shape).astype(np.float32)).to(torch.bfloat16)
    dr, dm = (T(rng.normal(size=s).astype(np.float32)) for s in ((Np, L), (8, L)))
    got = fused_edge.fused_edge_step_backward(*args, rcv, (gid, bt), 1, NODE_TILE, z, dz, dr, dm)
    assert [g.shape for g in got] == [a.shape for a in args]
    assert [g.dtype for g in got] == [torch.float32] * 2 + [torch.bfloat16] * 3 + [
        torch.float32] * 4
    pad = gid >= 1
    assert pad.any() and not got[2][pad].any() and not got[3][pad].any()


@pytest.mark.parametrize("n_tiles", [1, 3])
def test_csr_segment_sum_pair_matches_pallas(n_tiles):
    """Two fp32 streams over a sender view (receiver −1 on its padding
    slots), read through the permutation, against pallas_segment_sum_pair
    on the permuted streams; the first output is the first stream's."""
    rng = np.random.default_rng(5 + n_tiles)
    num_nodes = n_tiles * NODE_TILE
    E = 5 * 256 * n_tiles
    perm, srt, sbt = build_sender_view(rng.integers(0, num_nodes, size=E), num_nodes)
    assert (srt == -1).any()
    a, b = (rng.normal(size=(E, 8)).astype(np.float32) for _ in range(2))
    with pltpu.force_tpu_interpret_mode():
        want = pallas_segment_sum_pair(jnp.asarray(a[perm]), jnp.asarray(b[perm]),
                                       jnp.asarray(srt), jnp.asarray(sbt), num_nodes)
    got = csr_segment_sum_pair(T(a), T(b), T(srt), T(sbt), num_nodes, NODE_TILE, perm=T(perm))
    for x, y in zip(got, want):
        assert x.dtype == torch.float32 and x.shape == (num_nodes, 8)
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-4, atol=1e-4)


def test_csr_segment_sum_pair_has_no_backward():
    """It runs inside a backward; called where a gradient would be taken it
    raises instead of dropping it."""
    perm, srt, sbt = build_sender_view(np.arange(10) % 4, NODE_TILE)
    a = torch.zeros(10, 4, requires_grad=True)
    with pytest.raises(ValueError, match="no backward"):
        csr_segment_sum_pair(a, a.detach(), T(srt), T(sbt), NODE_TILE, NODE_TILE, perm=T(perm))
    with torch.no_grad():
        csr_segment_sum_pair(a, a, T(srt), T(sbt), NODE_TILE, NODE_TILE, perm=T(perm))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sender_gather_pair_matches_jax(dtype):
    """Forward (proj_v[snd], proj_u[snd]) in that order, and the VJP
    (d proj_u, d proj_v) in the order of the inputs, against the JAX pair
    gather, with distinct projections and cotangents so that a swap shows;
    two backward calls are bit-equal."""
    jdt, tdt = DTYPES[dtype]
    tol = 1e-4 if dtype == "float32" else 3e-2
    rng = np.random.default_rng(3)
    num_nodes = 2 * NODE_TILE
    E = 5 * num_nodes
    snd = rng.integers(0, num_nodes, size=E)
    view = build_sender_view(snd, num_nodes)
    pu, pv = (rng.normal(size=(num_nodes, 8)).astype(np.float32) for _ in range(2))
    cv, cu = (rng.normal(size=(E, 8)).astype(np.float32) for _ in range(2))

    def jax_fn(p_u, p_v):
        with pltpu.force_tpu_interpret_mode():
            return jax_sender_gather_pair(p_u, p_v, jnp.asarray(snd),
                                          *(jnp.asarray(v) for v in view), num_nodes)

    ju, jv = jnp.asarray(pu).astype(jdt), jnp.asarray(pv).astype(jdt)
    want_v, want_u = jax_fn(ju, jv)
    want_du, want_dv = jax.grad(
        lambda a, b: sum(jnp.sum(o.astype(jnp.float32) * c)
                         for o, c in zip(jax_fn(a, b), (cv, cu))), argnums=(0, 1))(ju, jv)

    def port():
        tu, tv = (T(p).to(tdt).requires_grad_() for p in (pu, pv))
        g_v, g_u = sender_gather_pair(tu, tv, T(snd.astype(np.int32)),
                                      tuple(T(v) for v in view), NODE_TILE)
        ((g_v.float() * T(cv)).sum() + (g_u.float() * T(cu)).sum()).backward()
        return g_v, g_u, tu.grad, tv.grad

    g_v, g_u, du, dv = port()
    for name, a, b in (("g_v", g_v, want_v), ("g_u", g_u, want_u)):
        np.testing.assert_array_equal(a.detach().float().numpy(),
                                      np.asarray(b.astype(jnp.float32)), err_msg=name)
    for name, a, b in (("d proj_u", du, want_du), ("d proj_v", dv, want_dv)):
        assert a.dtype == tdt, name
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b.astype(jnp.float32)),
                                   rtol=tol, atol=tol, err_msg=name)
    _, _, du2, dv2 = port()
    assert torch.equal(du, du2) and torch.equal(dv, dv2)


def test_sender_gather_pair_without_view_refuses_gradients():
    pu, pv = torch.zeros(4, 2, requires_grad=True), torch.ones(4, 2)
    snd = torch.tensor([0, 1, 3], dtype=torch.int32)
    with pytest.raises(ValueError, match="sender view"):
        sender_gather_pair(pu, pv, snd)
    with torch.no_grad():
        g_v, g_u = sender_gather_pair(pu, pv, snd)
    assert g_v.eq(1).all() and g_u.eq(0).all()


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_scatter_add_matches_jax(impl):
    """Receiver-layout messages (padding slots on each tile's last node)
    summed per node, and the gradient (a gather), against JAX scatter_add
    of the same impl (1e-4)."""
    arrays, idx = _edge_problem(2, 3, L=8)
    msgs = arrays["e"]
    Np = arrays["x"].shape[0]
    ct = np.random.default_rng(1).normal(size=(Np, 8)).astype(np.float32)

    def jax_fn(m):
        with pltpu.force_tpu_interpret_mode():
            return jax_scatter_add(m, jnp.asarray(idx["receivers"]), Np,
                                   block_tile=jnp.asarray(idx["block_tile"]), impl=impl)

    want = jax_fn(jnp.asarray(msgs))
    want_grad = jax.grad(lambda m: jnp.sum(jax_fn(m) * ct))(jnp.asarray(msgs))
    tm = T(msgs).requires_grad_()
    got = scatter_add(tm, T(idx["receivers"]), Np, T(idx["block_tile"]), impl=impl,
                      tile=NODE_TILE)
    (got * T(ct)).sum().backward()
    assert got.dtype == torch.float32 and got.shape == (Np, 8)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tm.grad.numpy(), np.asarray(want_grad), rtol=1e-4, atol=1e-4)


def test_scatter_add_rejects_unknown_impl():
    with pytest.raises(ValueError, match="unknown scatter impl"):
        scatter_add(torch.zeros(3, 2), torch.zeros(3, dtype=torch.int32), 2, impl="fused")
    with pytest.raises(ValueError, match="block_tile"):
        scatter_add(torch.zeros(3, 2), torch.zeros(3, dtype=torch.int32), 2, impl="pallas")


class _Stub(_CudaStub):
    """A CUDA tensor's stand-in that needs no gradient."""

    requires_grad = False


def _no_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)


def _no_fallback(*args, **kwargs):
    raise AssertionError("CUDA tensors reached a plain version")


@pytest.mark.parametrize("op", ["forward", "backward", "pair"])
def test_cuda_tensors_never_fall_back(monkeypatch, tmp_path, op):
    """With no nvcc each new CUDA wrapper raises; it never hands the call to
    its plain version, and its launch count does not move."""
    _no_nvcc(monkeypatch, tmp_path)
    stub = _Stub()
    if op == "forward":
        monkeypatch.setattr(fused_edge, "fused_edge_step_reference", _no_fallback)
        kernel = "fused_edge_fwd"
        call = lambda: fused_edge._fused_edge_step_forward(  # noqa: E731
            *([stub] * 12), 1, NODE_TILE)
    elif op == "backward":
        monkeypatch.setattr(fused_edge, "fused_edge_step_backward_reference", _no_fallback)
        kernel = "fused_edge_bwd"
        call = lambda: fused_edge.fused_edge_step_backward(  # noqa: E731
            *([stub] * 10), (stub, stub), 1, NODE_TILE, *([stub] * 4))
    else:
        monkeypatch.setattr(scatter_csr, "csr_segment_sum_pair_reference", _no_fallback)
        kernel = "segment_sum_csr_pair"
        call = lambda: csr_segment_sum_pair(  # noqa: E731
            stub, stub, stub, stub, NODE_TILE, NODE_TILE, stub)
    before = cuda_build.launches[kernel]
    with cuda_build.using(cuda_build.load_cuda_library), \
            pytest.raises(RuntimeError, match="nvcc not found"):
        call()
    assert cuda_build.launches[kernel] == before


@pytest.mark.parametrize("op", ["forward", "backward", "pair"])
def test_dispatch_rejects_mixed_devices(op):
    cpu = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="cuda or cpu"):
        if op == "forward":
            fused_edge.fused_edge_step(*([cpu] * 9), _CudaStub(), (cpu, cpu), 1, NODE_TILE)
        elif op == "backward":
            fused_edge.fused_edge_step_backward(
                *([cpu] * 9), _CudaStub(), (cpu, cpu), 1, NODE_TILE, *([cpu] * 4))
        else:
            csr_segment_sum_pair(cpu, cpu, _Stub(), cpu, NODE_TILE, NODE_TILE)
