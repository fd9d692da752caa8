"""Fused edge-step v3: the raw-x message-passing step of the fused3 path —
the counterpart of ``p_div_gnn_tpu/ops/fused_edge3.py`` (``fused_edge_step3``,
whose forward is the Pallas kernel ``_step3_kernel`` and whose VJP is the
Pallas kernel ``_step3_bwd_kernel``).

For each edge slot i with receiver r (the reference Processor,
`models.py:182-243`: the message puts the receiver in the first concat slot,
the edge update swaps the slots, and both share the edge MLP's weights):

    pre_msg = x[r]·Wu + g_x[i]·Wv + e[i]·We + b0
    pre_upd = x[r]·Wv + g_x[i]·Wu + e[i]·We + b0
    z_msg   = relu(relu(pre_msg)·W2 + b2) · mask_i
    z_upd   = relu(relu(pre_upd)·W2 + b2) · mask_i

Returns z_upd (Ep, L) in the stream dtype, R (Np, L) fp32 with
R[r] = Σ z_msg over the edges into r, and M (8, L) fp32 holding
Σz_msg, Σz_msg², Σz_upd, Σz_upd² and four zero rows. A slot is padding
(mask 0) where ``edge_gid >= n_graphs``.

``fused_edge_step3`` is an ``autograd.Function``. Its forward runs the
hand-written CUDA kernel (``csrc/fused_edge3_fwd.cu``) for CUDA tensors and
the plain PyTorch version ``fused_edge_step3_reference`` for CPU tensors;
its backward, ``fused_edge_step3_backward``, runs the CUDA kernel
``csrc/fused_edge3_bwd.cu`` or the plain ``fused_edge_step3_backward_reference``
the same way. There is no fallback from a kernel to a plain version. In bf16
stream mode all of them round where the JAX package rounds (``_mms``): bf16
operands with fp32 accumulation in every contraction, ``relu(pre)`` rounded
to bf16 before ``·W2``, R and dx summing bf16-rounded rows, M the fp32 z.
The receiver-side cotangent dR is gathered unrounded, as the JAX op does on
the CPU.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from p_div_gnn_tpu_torch.ops.cuda_build import CudaLibrary, check_launch, load_cuda_library
from p_div_gnn_tpu_torch.ops.segment import (
    live_slots,
    require_consecutive_runs,
    segment_sum,
    slot_outputs,
)
from p_div_gnn_tpu_torch.ops import wide
from p_div_gnn_tpu_torch.ops.widths import pad_args, padded_width, unpad_args, wide_strips

STREAM_DTYPES = (torch.float32, torch.bfloat16)


def fused_edge_step3_reference(
    x: torch.Tensor, g_x: torch.Tensor, e: torch.Tensor,
    w_u: torch.Tensor, w_v: torch.Tensor, w_e: torch.Tensor, b0: torch.Tensor,
    w2: torch.Tensor, b2: torch.Tensor,
    receivers: torch.Tensor, edge_gid: torch.Tensor, n_graphs: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: gather, matmuls and ``segment_sum``."""
    sd = g_x.dtype
    f = [t.float() for t in (w_u, w_v, w_e, b0, w2, b2)]
    wu, wv, we, b0f, w2f, b2f = f
    x_rows = x.float().index_select(0, receivers)
    gf = g_x.float()
    e_proj = e.float() @ we
    mask = (edge_gid < n_graphs).float()[:, None]

    def tail(pre: torch.Tensor) -> torch.Tensor:
        h = torch.relu(pre).to(sd).float()
        return torch.relu(h @ w2f + b2f) * mask

    z_msg = tail(x_rows @ wu + gf @ wv + e_proj + b0f)
    z_upd = tail(x_rows @ wv + gf @ wu + e_proj + b0f)
    r = segment_sum(z_msg.to(sd).float(), receivers, x.shape[0])
    # moment sums in fp64, rounded once, as the kernel takes them
    zm, zu = z_msg.double(), z_upd.double()
    m = torch.zeros((8, x.shape[1]), dtype=torch.float64, device=x.device)
    m[0], m[1], m[2], m[3] = zm.sum(0), (zm * zm).sum(0), zu.sum(0), (zu * zu).sum(0)
    return z_upd.to(sd), r, m.float()


@functools.cache
def _library() -> CudaLibrary:
    built = load_cuda_library("fused_edge3_fwd")
    fn = built.lib.pdg_fused_edge3_fwd
    fn.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 16 + [ctypes.c_int64] * 5 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    built.lib.pdg_fused_edge3_fwd_parts.argtypes = []
    built.lib.pdg_fused_edge3_fwd_parts.restype = ctypes.c_int64
    built.lib.pdg_fused_edge3_fwd_needs_wfma.argtypes = [ctypes.c_int, ctypes.c_int64]
    built.lib.pdg_fused_edge3_fwd_needs_wfma.restype = ctypes.c_int
    return built


# the widths the tile kernels are built for; any other L <= 256 runs at the
# next one, zero-padded, and a wider L at the wide variant (ops/widths.py)
FWD_WIDTHS = (64, 128, 256)
BWD_WIDTHS = (64, 128, 256)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_edge_step3: {msg}")


def _fused_edge_step3_cuda(
    x: torch.Tensor, g_x: torch.Tensor, e: torch.Tensor,
    w_u: torch.Tensor, w_v: torch.Tensor, w_e: torch.Tensor, b0: torch.Tensor,
    w2: torch.Tensor, b2: torch.Tensor,
    receivers: torch.Tensor, edge_gid: torch.Tensor, block_tile: torch.Tensor,
    n_graphs: int, tile: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    built = _library()
    Np, L = x.shape
    Ep = g_x.shape[0]
    sd = g_x.dtype
    floats = (x, g_x, e, w_u, w_v, w_e, b0, w2, b2)
    ints = (receivers, edge_gid, block_tile)
    _check(sd in STREAM_DTYPES, f"stream dtype {sd} is not float32 or bfloat16")
    _check(all(t.dtype == sd for t in floats), "x, g_x, e and the weights must share a dtype")
    _check(all(t.dtype == torch.int32 for t in ints), "index arrays must be int32")
    _check(len({t.device for t in floats + ints}) == 1, "tensors on several devices")
    _check(all(t.is_contiguous() for t in floats + ints), "tensors must be contiguous")
    _check(g_x.shape == (Ep, L) and e.shape == (Ep, L), "g_x and e must be (Ep, L)")
    _check(all(w.shape == (L, L) for w in (w_u, w_v, w_e, w2)), "weights must be (L, L)")
    _check(b0.shape == (L,) and b2.shape == (L,), "biases must be (L,)")
    _check(receivers.shape == (Ep,) and edge_gid.shape == (Ep,), "index arrays must be (Ep,)")
    n_blocks = block_tile.shape[0]
    _check(block_tile.dim() == 1 and n_blocks > 0 and Ep % n_blocks == 0,
           "edge slots must split into whole blocks")
    _check(tile > 0 and Np % tile == 0, f"Np={Np} is not a multiple of tile={tile}")
    Lp = padded_width(L, FWD_WIDTHS, "fused_edge_step3")
    _check(wide_strips(Lp) or (Np * Lp < 2**31 and Ep * Lp < 2**31), "arrays too large")
    # one writer per R row: each receiver's slots must be one run
    require_consecutive_runs(receivers, Np, "fused_edge_step3")
    if Lp != L:
        out = _fused_edge_step3_cuda(*pad_args(floats, "cccwwwcwc", Lp), *ints, n_graphs, tile)
        return unpad_args(out, "ccc", L)
    # the kernel runs the slots up to the last real one; the padding after
    # them has zero z_upd, messages and moments
    n = live_slots(edge_gid, n_graphs, Ep // n_blocks)
    if wide_strips(L):
        out = wide.forward(built, "fused_edge3_fwd", sd, n, Np, Ep, n_graphs, {
            "na": x, "ga": g_x, "e": e, "wu": w_u, "wv": w_v, "we": w_e, "w2": w2, "b0": b0,
            "b2": b2, "rcv": receivers, "gid": edge_gid})
        fused_edge_step3.launches += 1
        return out

    dev = x.device
    (z_upd,) = slot_outputs(n, 1, Ep, L, sd, dev)
    r = torch.empty((Np, L), dtype=torch.float32, device=dev)  # zeroed by the launch
    m = torch.empty((8, L), dtype=torch.float32, device=dev)
    bf16 = int(sd == torch.bfloat16)
    # the FMA chains read the four weights from one (4, L, L) fp32 block
    wfma = torch.empty((4, L, L), dtype=torch.float32, device=dev) \
        if built.lib.pdg_fused_edge3_fwd_needs_wfma(bf16, L) else None
    with torch.cuda.device(dev):
        n_parts = built.lib.pdg_fused_edge3_fwd_parts()
        _check(n_parts > 0, "cannot read the card's SM count")
        mpart = torch.empty((n_parts, 4, L), dtype=torch.float64, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = built.lib.pdg_fused_edge3_fwd(
            bf16,
            *(t.data_ptr() for t in (x, g_x, e, receivers, edge_gid, w_u, w_v, w_e, w2, b0, b2,
                                     z_upd, r)),
            None if wfma is None else wfma.data_ptr(), mpart.data_ptr(), m.data_ptr(),
            Np, n, L, int(n_graphs), n_parts, stream,
        )
    check_launch(built, err, "fused_edge3_fwd")
    fused_edge_step3.launches += 1
    return z_upd, r, m


def fused_edge_step3_backward_reference(
    x: torch.Tensor, g_x: torch.Tensor, e: torch.Tensor,
    w_u: torch.Tensor, w_v: torch.Tensor, w_e: torch.Tensor, b0: torch.Tensor,
    w2: torch.Tensor, b2: torch.Tensor,
    receivers: torch.Tensor, edge_gid: torch.Tensor, n_graphs: int,
    z_upd: torch.Tensor, dz_upd: torch.Tensor, dr: torch.Tensor, dm: torch.Tensor,
) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the backward (``_step3_bwd_kernel``): the
    forward is recomputed (z_msg re-masked), then the data cotangents and
    the weight grads are formed with matmuls. Returns fp32
    (dx (Np, L), dg, de, dWu, dWv, dWe, db0, dW2, db2), dg and de in the
    stream dtype. The weight grads sum over every slot in fp64 and round
    once: the exact sums of the products, which the kernel's tensor-core
    products (summed in fp32 over 32 slots, then in fp64) approach to their
    rounding."""
    sd = g_x.dtype
    Np = x.shape[0]

    def rnd(t: torch.Tensor) -> torch.Tensor:  # round through the stream dtype
        return t.to(sd).float()

    def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return rnd(a) @ rnd(b)

    def wsum(*pairs: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        return sum(rnd(a).double().T @ rnd(b).double() for a, b in pairs).float()

    wu, wv, we, w2f = (t.float() for t in (w_u, w_v, w_e, w2))
    # the cotangent products read contiguous transposes, as the kernel does
    wuT, wvT, weT, w2T = (t.T.contiguous() for t in (wu, wv, we, w2f))
    b0f, b2f = b0.float(), b2.float()
    mask = (edge_gid < n_graphs).float()[:, None]
    x_rows = x.float().index_select(0, receivers)
    gf, ef = g_x.float(), e.float()
    e_proj = mm(ef, we)
    pre1 = mm(x_rows, wu) + mm(gf, wv) + e_proj + b0f
    pre2 = mm(x_rows, wv) + mm(gf, wu) + e_proj + b0f
    h1, h2 = torch.relu(pre1), torch.relu(pre2)
    z_msg = torch.relu(mm(h1, w2f) + b2f) * mask
    z_u = z_upd.float()
    dmf = dm.float()

    dz_msg = dr.float().index_select(0, receivers) + dmf[0] + 2.0 * dmf[1] * z_msg
    dy1 = dz_msg * (z_msg > 0)
    dz_u = dz_upd.float() + dmf[2] + 2.0 * dmf[3] * z_u
    dy2 = dz_u * (z_u > 0)
    dpre1 = mm(dy1, w2T) * (h1 > 0)
    dpre2 = mm(dy2, w2T) * (h2 > 0)
    dps = dpre1 + dpre2

    dg = (mm(dpre1, wvT) + mm(dpre2, wuT)).to(sd)
    de = mm(dps, weT).to(sd)
    dx = segment_sum(rnd(mm(dpre1, wuT) + mm(dpre2, wvT)), receivers, Np)
    dw2 = wsum((h1, dy1), (h2, dy2))
    dwe = wsum((ef, dps))
    dwu = wsum((x_rows, dpre1), (gf, dpre2))
    dwv = wsum((x_rows, dpre2), (gf, dpre1))
    db2 = (dy1 + dy2).double().sum(0).float()
    db0 = dps.double().sum(0).float()
    return dx, dg, de, dwu, dwv, dwe, db0, dw2, db2


@functools.cache
def _bwd_library() -> CudaLibrary:
    built = load_cuda_library("fused_edge3_bwd")
    fn = built.lib.pdg_fused_edge3_bwd
    fn.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 28 + [ctypes.c_int64] * 5 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    for count in (built.lib.pdg_fused_edge3_bwd_parts, built.lib.pdg_fused_edge3_bwd_chunks):
        count.argtypes = [ctypes.c_int64]
        count.restype = ctypes.c_int64
    built.lib.pdg_wgrad_chunks.argtypes = [ctypes.c_int64, ctypes.c_int64]
    built.lib.pdg_wgrad_chunks.restype = ctypes.c_int64
    built.lib.pdg_fused_edge3_bwd_wgrad.argtypes = (
        [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
         ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
         ctypes.c_void_p])
    built.lib.pdg_fused_edge3_bwd_wgrad.restype = ctypes.c_int
    return built


def _fused_edge_step3_backward_cuda(
    x: torch.Tensor, g_x: torch.Tensor, e: torch.Tensor,
    w_u: torch.Tensor, w_v: torch.Tensor, w_e: torch.Tensor, b0: torch.Tensor,
    w2: torch.Tensor, b2: torch.Tensor,
    receivers: torch.Tensor, edge_gid: torch.Tensor, block_tile: torch.Tensor,
    n_graphs: int, tile: int,
    z_upd: torch.Tensor, dz_upd: torch.Tensor, dr: torch.Tensor, dm: torch.Tensor,
) -> tuple[torch.Tensor, ...]:
    built = _bwd_library()
    Np, L = x.shape
    Ep = g_x.shape[0]
    sd = g_x.dtype
    floats = (x, g_x, e, w_u, w_v, w_e, b0, w2, b2, z_upd, dz_upd)
    ints = (receivers, edge_gid, block_tile)
    f32 = (dr, dm)
    _check(sd in STREAM_DTYPES, f"stream dtype {sd} is not float32 or bfloat16")
    _check(all(t.dtype == sd for t in floats),
           "x, g_x, e, the weights, z_upd and dz_upd must share a dtype")
    _check(all(t.dtype == torch.float32 for t in f32), "dR and dM must be float32")
    _check(all(t.dtype == torch.int32 for t in ints), "index arrays must be int32")
    _check(len({t.device for t in floats + ints + f32}) == 1, "tensors on several devices")
    _check(all(t.is_contiguous() for t in floats + ints + f32), "tensors must be contiguous")
    _check(all(t.shape == (Ep, L) for t in (g_x, e, z_upd, dz_upd)),
           "g_x, e, z_upd and dz_upd must be (Ep, L)")
    _check(dr.shape == (Np, L) and dm.shape == (8, L), "dR must be (Np, L) and dM (8, L)")
    _check(all(w.shape == (L, L) for w in (w_u, w_v, w_e, w2)), "weights must be (L, L)")
    _check(b0.shape == (L,) and b2.shape == (L,), "biases must be (L,)")
    _check(receivers.shape == (Ep,) and edge_gid.shape == (Ep,), "index arrays must be (Ep,)")
    n_blocks = block_tile.shape[0]
    _check(block_tile.dim() == 1 and n_blocks > 0 and Ep % n_blocks == 0,
           "edge slots must split into whole blocks")
    _check(tile > 0 and Np % tile == 0, f"Np={Np} is not a multiple of tile={tile}")
    Lp = padded_width(L, BWD_WIDTHS, "fused_edge_step3_backward")
    _check(wide_strips(Lp) or (7 * Ep * Lp < 2**31 and Np * Lp < 2**31), "arrays too large")
    # one writer per dx row: each receiver's slots must be one run
    require_consecutive_runs(receivers, Np, "fused_edge_step3_backward")
    if Lp != L:
        out = _fused_edge_step3_backward_cuda(
            *pad_args(floats[:9], "cccwwwcwc", Lp), *ints, n_graphs, tile,
            *pad_args((z_upd, dz_upd, dr, dm), "cccc", Lp))
        return unpad_args(out, "cccwwwcwc", L)

    dev = x.device
    transposed = [w.t().contiguous() for w in (w_u, w_v, w_e, w2)]
    # the padding slots after the last real one have zero cotangents in
    # every product: dg and de are zero there, and they add nothing
    n = live_slots(edge_gid, n_graphs, Ep // n_blocks)
    if wide_strips(L):
        o = wide.backward(built, "fused_edge3_bwd", wide.F3, sd, n, Np, Ep, n_graphs, {
            "na": x, "ga": g_x, "e": e, "wu": w_u, "wv": w_v, "we": w_e, "w2": w2,
            **dict(zip(("wuT", "wvT", "weT", "w2T"), transposed)), "b0": b0, "b2": b2,
            "z_upd": z_upd, "dz": dz_upd, "dr": dr, "dm": dm, "rcv": receivers,
            "gid": edge_gid})
        fused_edge_step3_backward.launches += 1
        dw2, dwe, dwu, dwv = o["w_out"].unbind(0)
        return o["r_out"], o["dg"], o["de"], dwu, dwv, dwe, o["m_out"][1], dw2, o["m_out"][0]
    dg, de = slot_outputs(n, 2, Ep, L, sd, dev)
    dx = torch.zeros((Np, L), dtype=torch.float32, device=dev)
    scratch = torch.empty((7, n, L), dtype=sd, device=dev)
    # Wu, Wv, We, W2, W2ᵀ in fp32 for the FMA chains; Weᵀ, Wuᵀ, Wvᵀ as bf16
    # terms for the tensor cores, 3 per weight in fp32 mode
    wfma = torch.empty((5, L, L), dtype=torch.float32, device=dev)
    n_terms = 1 if sd == torch.bfloat16 else 3
    wsplit = torch.empty((3, n_terms, L, L), dtype=torch.int16, device=dev)
    bpart = torch.empty((built.lib.pdg_fused_edge3_bwd_parts(n), 2, L), dtype=torch.float64,
                        device=dev)
    # weight-grad partial sums: slots are cut into chunks, each summed by 8
    # CTAs (4 weight grads x 2 row halves)
    n_chunks = built.lib.pdg_fused_edge3_bwd_chunks(n)
    wpart = torch.empty((n_chunks, 4, L, L), dtype=torch.float64, device=dev)
    wb = torch.empty((4 * L + 2, L), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = built.lib.pdg_fused_edge3_bwd(
            int(sd == torch.bfloat16),
            *(t.data_ptr() for t in (x, g_x, e, z_upd, dz_upd, dr, dm, receivers, edge_gid,
                                     w_u, w_v, w_e, w2, *transposed, b0, b2,
                                     dg, de, dx, scratch, wsplit, wfma, bpart, wpart, wb)),
            Np, n, L, int(n_graphs), n_chunks, stream,
        )
    check_launch(built, err, "fused_edge3_bwd")
    fused_edge_step3_backward.launches += 1
    dw2, dwe, dwu, dwv = wb[:4 * L].view(4, L, L).unbind(0)
    return dx, dg, de, dwu, dwv, dwe, wb[4 * L + 1], dw2, wb[4 * L]


def fused_edge_step3_backward(
    x: torch.Tensor, g_x: torch.Tensor, e: torch.Tensor,
    w_u: torch.Tensor, w_v: torch.Tensor, w_e: torch.Tensor, b0: torch.Tensor,
    w2: torch.Tensor, b2: torch.Tensor,
    receivers: torch.Tensor, aux: tuple[torch.Tensor, torch.Tensor], n_graphs: int,
    tile: int,
    z_upd: torch.Tensor,  # (Ep, L) the forward's output, stream dtype
    dz_upd: torch.Tensor,  # (Ep, L) cotangents, stream dtype
    dr: torch.Tensor,  # (Np, L) fp32
    dm: torch.Tensor,  # (8, L) fp32
) -> tuple[torch.Tensor, ...]:
    """The fused3 edge step's VJP: fp32 (dx, dg, de, dWu, dWv, dWe, db0,
    dW2, db2), dg and de in the stream dtype. CUDA tensors go to the kernel
    (``fused_edge_step3_backward.launches`` counts its launches), which
    takes any L (64, 128 and 256 natively, another L <= 256 zero-padded to
    the next, a wider one in the wide variant) and each receiver's slots
    consecutive (the receiver-major layout; a pair-blocked batch's is not)
    and raises otherwise; CPU tensors go to the plain version; anything
    else raises."""
    edge_gid, block_tile = aux
    args = (x, g_x, e, w_u, w_v, w_e, b0, w2, b2, receivers)
    cots = (z_upd, dz_upd, dr, dm)
    kinds = {t.device.type for t in args + cots + (edge_gid, block_tile)}
    if kinds == {"cuda"}:
        return _fused_edge_step3_backward_cuda(
            *args, edge_gid, block_tile, n_graphs, tile, *cots)
    if kinds == {"cpu"}:
        return fused_edge_step3_backward_reference(*args, edge_gid, n_graphs, *cots)
    raise ValueError(
        f"fused_edge_step3_backward runs on cuda or cpu tensors, got {sorted(kinds)}")


fused_edge_step3_backward.launches = 0  # type: ignore[attr-defined]


def _fused_edge_step3_forward(
    x, g_x, e, w_u, w_v, w_e, b0, w2, b2, receivers, edge_gid, block_tile, n_graphs, tile
):
    args = (x, g_x, e, w_u, w_v, w_e, b0, w2, b2, receivers)
    kinds = {t.device.type for t in args + (edge_gid, block_tile)}
    if kinds == {"cuda"}:
        return _fused_edge_step3_cuda(*args, edge_gid, block_tile, n_graphs, tile)
    if kinds == {"cpu"}:
        return fused_edge_step3_reference(*args, edge_gid, n_graphs)
    raise ValueError(f"fused_edge_step3 runs on cuda or cpu tensors, got {sorted(kinds)}")


class _FusedEdgeStep3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g_x, e, w_u, w_v, w_e, b0, w2, b2, receivers, edge_gid, block_tile,
                n_graphs, tile):
        z_upd, r, m = _fused_edge_step3_forward(
            x, g_x, e, w_u, w_v, w_e, b0, w2, b2, receivers, edge_gid, block_tile,
            n_graphs, tile)
        # what the JAX VJP saves (`_step3_fwd`): the inputs and z_upd
        ctx.save_for_backward(x, g_x, e, w_u, w_v, w_e, b0, w2, b2, receivers, edge_gid,
                              block_tile, z_upd)
        ctx.n_graphs, ctx.tile = n_graphs, tile
        return z_upd, r, m

    @staticmethod
    def backward(ctx, dz_upd, dr, dm):
        (x, g_x, e, w_u, w_v, w_e, b0, w2, b2, receivers, edge_gid, block_tile,
         z_upd) = ctx.saved_tensors
        grads = fused_edge_step3_backward(
            x, g_x, e, w_u, w_v, w_e, b0, w2, b2, receivers, (edge_gid, block_tile),
            ctx.n_graphs, ctx.tile, z_upd, dz_upd.contiguous(), dr.contiguous(),
            dm.contiguous())
        inputs = (x, g_x, e, w_u, w_v, w_e, b0, w2, b2)
        return (*(gr.to(t.dtype) for gr, t in zip(grads, inputs)),) + (None,) * 5


def fused_edge_step3(
    x: torch.Tensor,  # (Np, L) node latents, stream dtype
    g_x: torch.Tensor,  # (Ep, L) sender gather of x
    e: torch.Tensor,  # (Ep, L) raw edge latents
    w_u: torch.Tensor,  # (L, L) target-slot first-layer weight
    w_v: torch.Tensor,  # (L, L) source-slot first-layer weight
    w_e: torch.Tensor,  # (L, L) edge-slot first-layer weight
    b0: torch.Tensor,  # (L,)
    w2: torch.Tensor,  # (L, L)
    b2: torch.Tensor,  # (L,)
    receivers: torch.Tensor,  # (Ep,) i32, block-aligned CSR
    aux: tuple[torch.Tensor, torch.Tensor],  # (edge_gid (Ep,), block_tile (NB,))
    n_graphs: int,
    tile: int,  # node tile of the layout (GraphBatch.tile)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused3 edge step: (z_upd, R, M), differentiable in x, g_x, e and
    the weights. CUDA tensors go to the kernels (``fused_edge_step3.launches``
    counts the forward's launches, ``fused_edge_step3_backward.launches``
    the backward's), which take each receiver's slots consecutive (the
    receiver-major layout; a pair-blocked batch's is not) and any L (64,
    128 and 256 natively, another L <= 256 zero-padded to the next, a wider
    one in the wide variant, ``ops/wide.py``; the padding is exact:
    ``ops/widths.py``), and raise otherwise; CPU tensors go to the plain
    versions; anything else raises."""
    edge_gid, block_tile = aux
    return _FusedEdgeStep3.apply(x, g_x, e, w_u, w_v, w_e, b0, w2, b2, receivers, edge_gid,
                                 block_tile, n_graphs, tile)


fused_edge_step3.launches = 0  # type: ignore[attr-defined]
