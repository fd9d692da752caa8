"""The zero padding of the latent width (``ops/widths.py``): each fused
kernel's wrapper runs a width L <= 256 it is not built for at the next
width it is, and a wider L at its wide variant on the next multiple of the
strip (64), with zero columns, weight rows and weight columns, and slices
the outputs back. On the CPU the wrappers take the plain versions, so these
tests hold the padding itself: for the six fused steps (#1, #2 the fused3
forward and backward, #5, #6 the v2 ones, #7, #8 the pair-blocked ones)
the plain version run through ``pad_args`` / ``unpad_args`` equals the
unpadded plain version bit for bit in fp32 at L = 16, 20, 96 and 192 (each
padded to the next of the kernels' widths 64, 128, 256) and 290 and 320
(the wide variant's 320), and, at L = 20, equals the JAX function (Pallas
interpret mode) at its own tolerance: the fused3 op's
(tests/test_fused3_op.py:65-70, :87-95) and the v2 op's
(tests/test_fused_op.py:86-91, :116-120), as rtol = atol. Every width
resolves to a tile build or the wide variant: none raises."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from p_div_gnn_tpu.ops.fused_edge import fused_edge_step as jax_step
from p_div_gnn_tpu.ops.fused_edge import fused_edge_step2 as jax_step2
from p_div_gnn_tpu.ops.fused_edge3 import fused_edge_step3 as jax_step3
from p_div_gnn_tpu_torch.graphs.container import NODE_TILE
from p_div_gnn_tpu_torch.ops import fused_edge, fused_edge3, widths

from test_torch_port_cuda import _edge_problem, _pair_problem, _v2_problem

T = torch.from_numpy
TILE_WIDTHS = (64, 128, 256)
KERNELS = ("fused3_fwd", "fused3_bwd", "v2_fwd", "v2_bwd", "pair_fwd", "pair_bwd")
FWD_TOL = (1e-5, 1e-4, 1e-3)
GRAD_TOL = 2e-4
# what each input and output pads (ops/widths.py: "c" the last dimension,
# "w" both, "-" nothing)
FUSED3_IN, V2_IN, PAIR_IN, COTS = "cccwwwcwc", "cccccwcwc", "cccwcwc", "cccc"


def _problem(kernel: str, L: int, n_tiles: int = 2):
    """(inputs, idx) of ``kernel``'s step at width L, as tensors, and the
    cotangents of its outputs (numpy, fp32)."""
    seed = 30 + KERNELS.index(kernel)
    make = {"fused3": _edge_problem, "v2": _v2_problem, "pair": _pair_problem}[
        kernel.split("_")[0]]
    arrays, idx = make(seed, n_tiles, L=L)
    Np = next(iter(arrays.values())).shape[0]
    Ep = len(idx["receivers"])
    rng = np.random.default_rng(seed + 1)
    cots = tuple(rng.normal(size=s).astype(np.float32) for s in ((Ep, L), (Np, L), (8, L)))
    return arrays, idx, cots


def _plain(kernel: str, args, idx, cots):
    """The kernel's plain version on fp32 ``args`` (a list of tensors of
    width L) with cotangents ``cots`` (dz_upd, dR, dM as tensors; the
    backwards' z_upd is the forward's): its outputs."""
    rcv, gid, bt = (T(np.asarray(idx[k])) for k in ("receivers", "edge_gid", "block_tile"))
    if kernel.startswith("fused3"):
        z, r, m = fused_edge3.fused_edge_step3_reference(*args, rcv, gid, 1)
        if kernel == "fused3_fwd":
            return z, r, m
        return fused_edge3.fused_edge_step3_backward_reference(*args, rcv, gid, 1, z, *cots)
    if kernel.startswith("v2"):
        z, r, m = fused_edge.fused_edge_step_reference(*args, rcv, gid, 1)
        if kernel == "v2_fwd":
            return z, r, m
        return fused_edge.fused_edge_step_backward_reference(*args, rcv, gid, 1, z, *cots)
    snd = T(np.asarray(idx["senders"]))
    aux = tuple(T(np.asarray(idx[k])) for k in ("edge_gid", "block_tile", "block_snd_tile"))
    z, r, m = fused_edge.fused_edge_step2_reference(*args, rcv, snd, aux, 1, NODE_TILE)
    if kernel == "pair_fwd":
        return z, r, m
    return fused_edge.fused_edge2_bwd_reference(*args, rcv, snd, aux, 1, NODE_TILE, z, *cots)


def _specs(kernel: str) -> tuple[str, str]:
    """(inputs, outputs) padding specs of a kernel."""
    ins = {"fused3": FUSED3_IN, "v2": V2_IN, "pair": PAIR_IN}[kernel.split("_")[0]]
    if kernel.endswith("fwd"):
        return ins, "ccc"
    return ins, {"fused3": "cccwwwcwc", "v2": "cccccwcwc", "pair": "cccccwcwc"}[
        kernel.split("_")[0]]


def _padded_plain(kernel: str, args, idx, cots, L: int):
    """The plain version through the padding, at the next tile width."""
    Lp = widths.padded_width(L, TILE_WIDTHS, kernel)
    ins, outs = _specs(kernel)
    out = _plain(kernel, widths.pad_args(args, ins, Lp), idx,
                 widths.pad_args(cots, COTS[:len(cots)], Lp))
    return widths.unpad_args(out, outs, L)


@pytest.mark.parametrize("L", [16, 20, 96, 192, 290, 320])
@pytest.mark.parametrize("kernel", KERNELS)
def test_padding_is_exact_in_the_plain_versions(kernel, L):
    """Every output through the padding equals the unpadded plain version
    bit for bit in fp32, with the unpadded shapes."""
    arrays, idx, cots = _problem(kernel, L)
    args = [T(a) for a in arrays.values()]
    c = tuple(T(x) for x in cots) if kernel.endswith("bwd") else ()
    want = _plain(kernel, args, idx, c)
    got = _padded_plain(kernel, args, idx, c, L)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and a.dtype == b.dtype, i
        assert torch.equal(a, b), f"{kernel} L={L} output {i}"


def _jax_forward(kernel: str, jargs, idx):
    rcv = jnp.asarray(idx["receivers"])
    with pltpu.force_tpu_interpret_mode():
        if kernel.startswith("fused3"):
            return jax_step3(*jargs, rcv, (jnp.asarray(idx["edge_gid"]),
                                           jnp.asarray(idx["block_tile"])), 1)
        if kernel.startswith("v2"):
            return jax_step(*jargs, rcv, (jnp.asarray(idx["edge_gid"]),
                                          jnp.asarray(idx["block_tile"])), 1)
        aux = tuple(jnp.asarray(idx[k]) for k in ("edge_gid", "block_tile", "block_snd_tile",
                                                   "snd_perm", "snd_sorted", "snd_block_tile"))
        return jax_step2(*jargs, rcv, jnp.asarray(idx["senders"]), aux, 1)


@pytest.mark.parametrize("kernel", KERNELS)
def test_padded_plain_versions_match_jax(kernel):
    """At L = 20 (padded to 64), fp32: the forwards' (z_upd, R, M) and the
    backwards' gradients of every input (the fused2 backward's through its
    whole VJP, the sender sums included) equal the JAX function's at its
    tolerance."""
    L = 20
    arrays, idx, cots = _problem(kernel, L)
    jargs = tuple(jnp.asarray(a) for a in arrays.values())
    args = [T(a) for a in arrays.values()]
    if kernel.endswith("fwd"):
        want = _jax_forward(kernel, jargs, idx)
        got = _padded_plain(kernel, args, idx, (), L)
        for a, b, tol in zip(got, want, FWD_TOL, strict=True):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=tol, atol=tol)
        return
    cz, cr, cm = cots

    def jax_loss(a):
        z, r, m = _jax_forward(kernel, a, idx)
        return jnp.sum(z * cz) + jnp.sum(r * cr) + jnp.sum(m * cm)

    want = jax.grad(jax_loss)(jargs)
    c = (T(cz), T(cr), T(cm))
    if kernel == "pair_bwd":
        Lp = widths.padded_width(L, TILE_WIDTHS, kernel)
        rcv, snd = T(idx["receivers"]), T(idx["senders"])
        aux = tuple(T(np.asarray(idx[k])) for k in (
            "edge_gid", "block_tile", "block_snd_tile", "snd_perm", "snd_sorted",
            "snd_block_tile"))
        pargs = widths.pad_args(args, PAIR_IN, Lp)
        z, _, _ = fused_edge.fused_edge_step2_reference(*pargs, rcv, snd, aux, 1, NODE_TILE)
        got = widths.unpad_args(fused_edge.fused_edge_step2_backward_reference(
            *pargs, rcv, snd, aux, 1, NODE_TILE, z, *widths.pad_args(c, "ccc", Lp)),
            PAIR_IN, L)
    else:
        got = _padded_plain(kernel, args, idx, c, L)
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=f"{kernel} grad {i}")


def test_widths_resolve_to_a_tile_build_or_the_wide_variant():
    """Every fused wrapper's width table: L <= 256 runs at the next width a
    tile kernel is built for (no strips); L = 257, 320 and 512 run at the
    wide variant on the next multiple of 64, in 5, 5 and 8 strips; no
    width raises."""
    for table in (fused_edge3.FWD_WIDTHS, fused_edge3.BWD_WIDTHS, fused_edge.FWD_WIDTHS,
                  fused_edge.BWD_WIDTHS):
        assert max(table) == widths.MAX_WIDTH == 256
        for L, want in ((1, 64), (16, 64), (64, 64), (96, 128), (128, 128), (200, 256),
                        (256, 256)):
            Lp = widths.padded_width(L, table, "a kernel")
            assert Lp == want and Lp in table and widths.wide_strips(Lp) == 0
        for L, want, strips in ((257, 320, 5), (320, 320, 5), (512, 512, 8), (600, 640, 10)):
            Lp = widths.padded_width(L, table, "a kernel")
            assert (Lp, widths.wide_strips(Lp)) == (want, strips)
    with pytest.raises(ValueError, match="not a width"):
        widths.padded_width(0, fused_edge.FWD_WIDTHS, "a kernel")
    w = torch.arange(6.0).reshape(2, 3)
    p = widths.pad_args([w, w, w], "cw-", 4)
    assert p[0].shape == (2, 4) and p[1].shape == (4, 4) and p[2] is w
    assert not p[1][2:].any() and not p[1][:, 3:].any()
    u = widths.unpad_args(p[:2], "cw", 3)
    assert torch.equal(u[0], w) and u[1].shape == (3, 3) and torch.equal(u[1][:2], w)
