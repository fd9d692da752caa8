"""The pair-blocked ("fused2") slice against the JAX package on the same
numpy inputs: the pair-blocked layout (``blockify_edges_pair``,
``pack_batch(pair_blocks=True)``), the fused2 edge step (forward and VJP,
the port's ``autograd.Function`` with its plain versions against JAX
``fused_edge_step2``, whose forward and VJP are the Pallas kernels
``_step2_kernel`` and ``_step2_bwd_kernel``), the whole fused2 model
(forward, loss gradient leaf by leaf, Adam steps of ``Trainer``) and
``Predictor(scatter_impl="fused2")`` on the committed checkpoint. The JAX
kernels run as the JAX package's own tests run them on the CPU (Pallas
interpret mode; JAX models with ``remat_steps=False``). Also the dispatch of
the new CUDA wrappers: a CUDA tensor reaches a kernel or an error, never a
plain version.

Tolerances are the JAX package's own, as rtol = atol: the fused2 op shares
the v2 op's (tests/test_fused_op.py:86-91 forward, :116-120 gradients), 3e-2
for bf16 streams (tests/test_fused3_op.py:128); the whole model its
fused2-vs-xla tolerances (tests/test_fused_op.py:214-250: forward rtol 1e-4
/ atol 1e-5, gradients rtol 2e-3 / atol 1e-4); serving the fused-vs-xla
tolerance on standardized outputs (tests/test_fused.py:34); losses at rtol
1e-5 and, after three Adam steps, the parameters at atol 1e-4 + rtol 1e-5,
as test_torch_port_impls.py holds "fused"."""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from p_div_gnn_tpu.graphs import batching as jax_batching
from p_div_gnn_tpu.graphs.batching import unpack_predictions as jax_unpack
from p_div_gnn_tpu.graphs.container import NormStats as JaxNormStats
from p_div_gnn_tpu.models import EncodeProcessDecode as JaxEPD
from p_div_gnn_tpu.ops.fused_edge import fused_edge_step2 as jax_step2
from p_div_gnn_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from p_div_gnn_tpu.train.loop import Trainer as JaxTrainer
from p_div_gnn_tpu_torch.graphs import batching
from p_div_gnn_tpu_torch.graphs.container import NODE_TILE, NormStats
from p_div_gnn_tpu_torch.inference import Predictor
from p_div_gnn_tpu_torch.models.epd import EncodeProcessDecode
from p_div_gnn_tpu_torch.models.params import params_from_jax, params_to_jax
from p_div_gnn_tpu_torch.ops import cuda_build, fused_edge
from p_div_gnn_tpu_torch.train.loop import Trainer

from test_torch_port_cuda import _pair_problem
from test_torch_port_graphs import _port_sample, _to_jax_sample
from test_torch_port_model import CKPT, STATS
from test_torch_port_ops import _CudaStub

T = torch.from_numpy
NAMES = ("proj_u", "proj_v", "e", "w_e", "b0", "w2", "b2")
AUX = ("edge_gid", "block_tile", "block_snd_tile", "snd_perm", "snd_sorted", "snd_block_tile")
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
FWD_TOL = {"float32": (1e-5, 1e-4, 1e-3), "bfloat16": (3e-2,) * 3}
GRAD_TOL = {"float32": 2e-4, "bfloat16": 3e-2}
L, STEPS, LAMBDA = 16, 2, 10.0


def _jax_args(arrays, idx, jdt):
    args = tuple(jnp.asarray(a).astype(jdt) for a in arrays.values())
    return (args, jnp.asarray(idx["receivers"]), jnp.asarray(idx["senders"]),
            tuple(jnp.asarray(idx[k]) for k in AUX))


def _port_idx(idx):
    return (T(idx["receivers"]), T(idx["senders"]),
            tuple(T(np.array(idx[k])) for k in AUX))


def _assert_batches_equal(got, ref):
    assert (got.n_graphs, got.tile) == (ref.n_graphs, ref.tile)
    for name in got.array_fields():
        a, b = getattr(got, name), getattr(ref, name)
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == np.asarray(b).dtype, name
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)


@pytest.mark.parametrize("n_tiles", [1, 3])
def test_blockify_edges_pair_matches_jax(n_tiles):
    """Every output of the pair layout equals the JAX package's, with the
    groups padded to whole blocks and a capacity above the layout's."""
    rng = np.random.default_rng(n_tiles)
    num_nodes = n_tiles * NODE_TILE
    E = 3 * num_nodes
    rcv = np.sort(rng.integers(0, num_nodes - NODE_TILE // 2, size=E)).astype(np.int32)
    snd = np.clip(rcv + rng.integers(-300, 300, size=E), 0, num_nodes - 1).astype(np.int32)
    ew = rng.normal(size=(E, 1)).astype(np.float32)
    gid = (rcv >= num_nodes // 2).astype(np.int32)
    first = batching.blockify_edges_pair(snd, rcv, ew, gid, num_nodes, 2)
    cap = len(first[0]) + 2 * 768
    got = batching.blockify_edges_pair(snd, rcv, ew, gid, num_nodes, 2, min_capacity=cap)
    want = jax_batching.blockify_edges_pair(snd, rcv, ew, gid, num_nodes, 2,
                                            min_capacity=cap)
    assert len(got) == len(want) == 7 and len(got[0]) == cap
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype, i
        np.testing.assert_array_equal(a, b, err_msg=str(i))
    assert np.all(np.diff(got[5]) >= 0)  # receiver-tile-major


@pytest.mark.parametrize("reorder", [None, "rcm"])
def test_pack_batch_pair_blocks_matches_jax(reorder):
    """Every field of a pair-blocked batch, edge_block_snd_tile and the
    sender view over the pair layout's senders included, equals the JAX
    packer's; every block's endpoints lie in its two tiles."""
    samples = [_port_sample(s) for s in (0, 1, 2)]
    got = batching.pack_batch(samples, n_graphs=4, reorder=reorder, pair_blocks=True)
    ref = jax_batching.pack_batch([_to_jax_sample(s) for s in samples], n_graphs=4,
                                  reorder=reorder, pair_blocks=True)
    _assert_batches_equal(got, ref)
    n_blocks = len(got.edge_block_tile)
    rt = got.receivers.reshape(n_blocks, -1) // got.tile
    st = got.senders.reshape(n_blocks, -1) // got.tile
    assert (rt == got.edge_block_tile[:, None]).all()
    assert (st == got.edge_block_snd_tile[:, None]).all()
    moved = got.to("cpu")
    assert torch.equal(moved.edge_block_snd_tile, T(got.edge_block_snd_tile))


@pytest.mark.parametrize("n_tiles", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_edge_step2_matches_jax(dtype, n_tiles):
    """z_upd, R and M over one and three node tiles of the pair layout, with
    padding slots and (three tiles) a receiver and a sender outside their
    block's tiles."""
    jdt, tdt = DTYPES[dtype]
    arrays, idx = _pair_problem(11 + n_tiles, n_tiles, L=16)
    args, rcv, snd, aux = _jax_args(arrays, idx, jdt)
    with pltpu.force_tpu_interpret_mode():
        want = jax_step2(*args, rcv, snd, aux, 1)
    got = fused_edge.fused_edge_step2(*(T(a).to(tdt) for a in arrays.values()),
                                      *_port_idx(idx), 1, NODE_TILE)
    assert got[0].dtype == tdt and got[1].dtype == got[2].dtype == torch.float32
    for name, a, b, tol in zip(("z_upd", "R", "M"), got, want, FWD_TOL[dtype]):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b.astype(jnp.float32)),
                                   rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("n_tiles", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_edge_step2_grads_match_jax(dtype, n_tiles):
    """Every input and weight, with nonzero cotangents on z_upd, R and M;
    each gradient comes back in its input's dtype, as the JAX VJP returns
    it."""
    jdt, tdt = DTYPES[dtype]
    arrays, idx = _pair_problem(21 + n_tiles, n_tiles, L=16)
    Np, Lw = arrays["proj_u"].shape
    Ep = arrays["e"].shape[0]
    rng = np.random.default_rng(7)
    cz, cr, cm = (rng.normal(size=s).astype(np.float32) for s in ((Ep, Lw), (Np, Lw), (8, Lw)))
    args, rcv, snd, aux = _jax_args(arrays, idx, jdt)

    def jax_loss(a):
        with pltpu.force_tpu_interpret_mode():
            z, r, m = jax_step2(*a, rcv, snd, aux, 1)
        return jnp.sum(z.astype(jnp.float32) * cz) + jnp.sum(r * cr) + jnp.sum(m * cm)

    want = jax.grad(jax_loss)(args)
    targs = [T(a).to(tdt).requires_grad_() for a in arrays.values()]
    z, r, m = fused_edge.fused_edge_step2(*targs, *_port_idx(idx), 1, NODE_TILE)
    ((z.float() * T(cz)).sum() + (r * T(cr)).sum() + (m * T(cm)).sum()).backward()
    tol = GRAD_TOL[dtype]
    for name, a, b in zip(NAMES, targs, want):
        assert a.grad.dtype == tdt == a.dtype, name
        np.testing.assert_allclose(a.grad.float().numpy(), np.asarray(b.astype(jnp.float32)),
                                   rtol=tol, atol=tol, err_msg=f"grad {name}")


def test_backward_reference_is_the_autograd_backward():
    """On a layout with every endpoint in its block's tiles, the plain VJP
    (the plain backward kernel and the sender sums) is autograd's gradient
    of the plain forward; the backward kernel's plain version gives de,
    dpre1, dpre2 in the stream dtype (zero on the padding slots) and the
    receiver sums and weight grads in fp32."""
    arrays, idx = _pair_problem(4, 3, L=8, stray=False)
    rcv, snd, aux = _port_idx(idx)
    args = [T(a).requires_grad_() for a in arrays.values()]
    z, r, m = fused_edge.fused_edge_step2_reference(*args, rcv, snd, aux, 1, NODE_TILE)
    rng = np.random.default_rng(3)
    dz, dr, dm = (T(rng.normal(size=t.shape).astype(np.float32)) for t in (z, r, m))
    want = torch.autograd.grad((z * dz).sum() + (r * dr).sum() + (m * dm).sum(), args)
    plain = [a.detach() for a in args]
    cots = (z.detach(), dz, dr, dm)
    got = fused_edge.fused_edge_step2_backward_reference(*plain, rcv, snd, aux, 1, NODE_TILE,
                                                         *cots)
    for name, a, b in zip(NAMES, got, want):
        assert a.shape == b.shape and a.dtype == torch.float32, name
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, msg=name)
    # the VJP on the CPU takes the same plain versions
    dispatched = fused_edge.fused_edge_step2_backward(*plain, rcv, snd, aux, 1, NODE_TILE,
                                                      *cots)
    for a, b in zip(dispatched, got):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    bf = [a.to(torch.bfloat16) for a in plain]
    zb = fused_edge.fused_edge_step2_reference(*bf, rcv, snd, aux, 1, NODE_TILE)[0]
    parts = fused_edge.fused_edge2_bwd(*bf, rcv, snd, aux, 1, NODE_TILE, zb,
                                       dz.to(torch.bfloat16), dr, dm)
    assert [p.dtype for p in parts] == [torch.bfloat16] * 3 + [torch.float32] * 6
    pad = aux[0] >= 1
    assert pad.any() and not any(p[pad].any() for p in parts[:3])


def _batches(seeds, n_graphs):
    samples = [_port_sample(s) for s in seeds]
    host = batching.pack_batch(samples, n_graphs=n_graphs, reorder="rcm", pair_blocks=True)
    ref = jax_batching.pack_batch([_to_jax_sample(s) for s in samples], n_graphs=n_graphs,
                                  reorder="rcm", pair_blocks=True)
    return samples, host, ref


@pytest.fixture(scope="module")
def setup():
    _, host, ref = _batches((0, 1), n_graphs=3)
    model = JaxEPD(latent_size=L, message_passing_steps=STEPS, scatter_impl="fused2",
                   remat_steps=False)
    params = model.init(jax.random.PRNGKey(0), ref, JaxNormStats.from_dict(STATS))
    return host, ref, params


def _port_model(params, stream_dtype="float32"):
    model = EncodeProcessDecode(latent_size=L, message_passing_steps=STEPS,
                                scatter_impl="fused2", stream_dtype=stream_dtype,
                                remat_steps=False)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)), strict=True)
    return model


def _jax_trainer():
    model = JaxEPD(latent_size=L, message_passing_steps=STEPS, scatter_impl="fused2",
                   remat_steps=False)
    return JaxTrainer(model=model, stats=JaxNormStats.from_dict(STATS), learning_rate=1e-3,
                      divergence_penalty=LAMBDA, optimize_divergence=True)


def _port_trainer(params):
    return Trainer(_port_model(params), NormStats.from_dict(STATS), learning_rate=1e-3,
                   divergence_penalty=LAMBDA, optimize_divergence=True, device="cpu")


def _leaves(tree):
    return {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("stream_dtype", ["float32", "bfloat16"])
def test_fused2_forward_matches_jax(setup, stream_dtype):
    """The JAX fused2 model's parameter tree in the port's fused2 model on
    array-equal pair-blocked batches gives the same output."""
    host, ref, params = setup
    jstats = JaxNormStats.from_dict(STATS)
    jmodel = JaxEPD(latent_size=L, message_passing_steps=STEPS, scatter_impl="fused2",
                    stream_dtype=stream_dtype, remat_steps=False)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jmodel.apply(params, ref, jstats, scale_output=False))
    model = _port_model(params, stream_dtype).eval()
    with torch.no_grad():
        got = model(host.to("cpu"), NormStats.from_dict(STATS), scale_output=False).numpy()
    real = host.node_gid < host.n_graphs
    tol = dict(rtol=1e-4, atol=1e-5) if stream_dtype == "float32" else dict(rtol=3e-2,
                                                                            atol=3e-2)
    np.testing.assert_allclose(got[real], want[real], **tol)
    assert np.all(np.isfinite(got))


def test_fused2_loss_gradient_matches_jax(setup):
    """The training loss and its gradient leaf by leaf against
    ``jax.grad(Trainer._loss_fn)`` of the JAX fused2 model."""
    host, ref, params = setup
    with pltpu.force_tpu_interpret_mode():
        (want_total, _), want = jax.jit(
            jax.value_and_grad(_jax_trainer()._loss_fn, has_aux=True))(params, ref)
    aux, grads = _port_trainer(params).loss_and_grads(host.to("cpu"))
    np.testing.assert_allclose(float(aux["total"]), float(want_total), rtol=1e-5)
    got, want = _leaves(params_to_jax(grads)), _leaves(want)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-3, atol=1e-4, err_msg=k)


def test_three_adam_steps_match_jax(setup):
    """``Trainer(device="cpu")`` takes any pair-blocked batch that has the
    sender view: three fused2 Adam steps match three JAX steps."""
    host, ref, params = setup
    trainer = _jax_trainer()
    p, opt_state = jax.tree.map(jnp.array, params), trainer.optimizer.init(params)
    step = jax.jit(trainer._train_step_impl)
    want_totals = []
    with pltpu.force_tpu_interpret_mode():
        for _ in range(3):
            p, opt_state, aux = step(p, opt_state, ref)
            want_totals.append(float(aux["total"]))
    port = _port_trainer(params)
    port.init()
    got_totals = [float(port.train_step(host)["total"]) for _ in range(3)]
    np.testing.assert_allclose(got_totals, want_totals, rtol=1e-5)
    assert got_totals[-1] < got_totals[0]
    got, want = _leaves(params_to_jax(port.model.state_dict())), _leaves(p)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-4, err_msg=k)


def test_fused2_needs_a_pair_blocked_batch(setup):
    """A receiver-major batch has no edge_block_snd_tile: fused2 raises."""
    _, _, params = setup
    samples = [_port_sample(s) for s in (0, 1)]
    batch = batching.pack_batch(samples, n_graphs=3, reorder="rcm").to("cpu")
    assert batch.edge_block_snd_tile is None
    with pytest.raises(ValueError, match="pair_blocks=True"), torch.no_grad():
        _port_model(params)(batch, NormStats.from_dict(STATS))


def test_fused2_training_needs_the_sender_view(setup):
    """Without the sender view the fused2 step raises under grad; it still
    evaluates."""
    host, _, params = setup
    batch = host.to("cpu")
    batch.snd_perm = batch.snd_sorted = batch.snd_block_tile = None
    trainer = _port_trainer(params)
    with pytest.raises(ValueError, match="sender view"):
        trainer.loss(batch)
    with torch.no_grad():
        trainer.eval_step(batch)


def test_predictor_fused2_with_checkpoint_matches_jax():
    """Serving through "fused2": the committed checkpoint at full width
    (L=128, 10 steps) on small meshes, packed pair-blocked by the port's
    Predictor on the CPU, against the JAX fused2 forward with the same
    weights and stats, per mesh in original node order."""
    samples, _, ref = _batches((0, 1), n_graphs=2)
    got = Predictor(CKPT, scatter_impl="fused2", device="cpu").predict(samples)
    jmodel = JaxEPD(latent_size=128, message_passing_steps=10, scatter_impl="fused2",
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
                                   rtol=2e-4, atol=2e-5)


class _Stub(_CudaStub):
    """A CUDA tensor's stand-in that needs no gradient."""

    requires_grad = False


def _no_fallback(*args, **kwargs):
    raise AssertionError("CUDA tensors reached a plain version")


@pytest.mark.parametrize("op", ["forward", "backward"])
def test_cuda_tensors_never_fall_back(monkeypatch, tmp_path, op):
    """With no nvcc each new CUDA wrapper raises; it never hands the call to
    its plain version, and its launch count does not move."""
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    stub = _Stub()
    if op == "forward":
        monkeypatch.setattr(fused_edge, "fused_edge_step2_reference", _no_fallback)
        kernel = "fused_edge2_fwd"
        call = lambda: fused_edge._fused_edge_step2_forward(  # noqa: E731
            *([stub] * 9), (stub,) * 3, 1, NODE_TILE)
    else:
        monkeypatch.setattr(fused_edge, "fused_edge2_bwd_reference", _no_fallback)
        monkeypatch.setattr(fused_edge, "fused_edge_step2_backward_reference", _no_fallback)
        kernel = "fused_edge2_bwd"
        call = lambda: fused_edge.fused_edge_step2_backward(  # noqa: E731
            *([stub] * 9), (stub,) * 6, 1, NODE_TILE, *([stub] * 4))
    before = cuda_build.launches[kernel]
    with cuda_build.using(cuda_build.load_cuda_library), \
            pytest.raises(RuntimeError, match="nvcc not found"):
        call()
    assert cuda_build.launches[kernel] == before


@pytest.mark.parametrize("op", ["forward", "backward", "kernel"])
def test_dispatch_rejects_mixed_devices(op):
    cpu = torch.zeros(4, 4)
    aux = (cpu, cpu, cpu, cpu, cpu, cpu)
    with pytest.raises(ValueError, match="cuda or cpu"):
        if op == "forward":
            fused_edge.fused_edge_step2(*([cpu] * 7), _CudaStub(), cpu, aux, 1, NODE_TILE)
        elif op == "backward":
            fused_edge.fused_edge_step2_backward(
                *([cpu] * 7), _Stub(), cpu, aux, 1, NODE_TILE, *([cpu] * 4))
        else:
            fused_edge.fused_edge2_bwd(
                *([cpu] * 8), _Stub(), aux, 1, NODE_TILE, *([cpu] * 4))


def test_library_name_follows_its_shared_header(monkeypatch, tmp_path):
    """An edit of a shared header renames (so rebuilds) each library that
    includes it, and no other: the three forwards share
    csrc/fwd_common.cuh, the v2 and the pair-blocked forward
    csrc/v2_fwd_tile.cuh, the three backwards csrc/bwd_common.cuh, the v2
    and the pair-blocked backward csrc/v2_bwd_tile.cuh, all six fused
    kernels csrc/fused3_tile.cuh and csrc/wide_tile.cuh (their wide
    variant)."""
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, csrc)
    monkeypatch.setattr(cuda_build, "CSRC_DIR", csrc)
    names = ("fused_edge_fwd", "fused_edge_bwd", "fused_edge2_fwd", "fused_edge2_bwd",
             "fused_edge3_fwd", "fused_edge3_bwd")
    includers = {
        "fwd_common.cuh": ["fused_edge_fwd", "fused_edge2_fwd", "fused_edge3_fwd"],
        "v2_fwd_tile.cuh": ["fused_edge_fwd", "fused_edge2_fwd"],
        "bwd_common.cuh": ["fused_edge_bwd", "fused_edge2_bwd", "fused_edge3_bwd"],
        "v2_bwd_tile.cuh": ["fused_edge_bwd", "fused_edge2_bwd"],
        "fused3_tile.cuh": list(names),
        "wide_tile.cuh": list(names),
    }
    for name, want in includers.items():
        before = {n: cuda_build.library_path(n) for n in names}
        header = csrc / name
        header.write_text(header.read_text() + "\n// edited\n")
        after = {n: cuda_build.library_path(n) for n in names}
        assert [n for n in names if before[n] != after[n]] == want, name
