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

import torch

from p_div_gnn_tpu_torch.ops import cuda_build, wide
from p_div_gnn_tpu_torch.ops.fused_edge import check_step_inputs, forward_scratch
from p_div_gnn_tpu_torch.ops.segment import (
    live_slots,
    require_consecutive_runs,
    segment_sum,
    slot_outputs,
)
from p_div_gnn_tpu_torch.ops.widths import pad_args, unpad_args, wide_strips


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


# the widths the tile kernels are built for; any other L <= 256 runs at the
# next one, zero-padded, and a wider L at the wide variant (ops/widths.py)
FWD_WIDTHS = (64, 128, 256)
BWD_WIDTHS = (64, 128, 256)


def _fused_edge_step3_cuda(
    x: torch.Tensor, g_x: torch.Tensor, e: torch.Tensor,
    w_u: torch.Tensor, w_v: torch.Tensor, w_e: torch.Tensor, b0: torch.Tensor,
    w2: torch.Tensor, b2: torch.Tensor,
    receivers: torch.Tensor, edge_gid: torch.Tensor, block_tile: torch.Tensor,
    n_graphs: int, tile: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    built = cuda_build.library("fused_edge3_fwd")
    floats = (x, g_x, e, w_u, w_v, w_e, b0, w2, b2)
    Np, Ep, L, Lp = check_step_inputs("fused_edge_step3", FWD_WIDTHS, tile, (1, 1),
                                      "nsswwwbwbiit", *floats, receivers, edge_gid, block_tile)
    # one writer per R row: each receiver's slots must be one run
    require_consecutive_runs(receivers, Np, "fused_edge_step3")
    if Lp != L:
        out = _fused_edge_step3_cuda(*pad_args(floats, "cccwwwcwc", Lp), receivers, edge_gid,
                                     block_tile, n_graphs, tile)
        return unpad_args(out, "ccc", L)
    sd, dev = g_x.dtype, x.device
    # the kernel runs the slots up to the last real one; the padding after
    # them has zero z_upd, messages and moments
    n = live_slots(edge_gid, n_graphs, Ep // block_tile.shape[0])
    if wide_strips(L):
        return wide.forward("fused_edge3_fwd", sd, n, Np, Ep, n_graphs, {
            "na": x, "ga": g_x, "e": e, "wu": w_u, "wv": w_v, "we": w_e, "w2": w2, "b0": b0,
            "b2": b2, "rcv": receivers, "gid": edge_gid})
    (z_upd,) = slot_outputs(n, 1, Ep, L, sd, dev)
    r = torch.empty((Np, L), dtype=torch.float32, device=dev)  # zeroed by the launch
    m = torch.empty((8, L), dtype=torch.float32, device=dev)
    # the FMA chains read the four weights from one (4, L, L) fp32 block
    n_parts, wfma, mpart = forward_scratch(built, "fused_edge3_fwd", sd, L, dev, 4)
    cuda_build.launch("fused_edge3_fwd", "pdg_fused_edge3_fwd", int(sd == torch.bfloat16),
                      x, g_x, e, receivers, edge_gid, w_u, w_v, w_e, w2, b0, b2, z_upd, r, wfma,
                      mpart, m, Np, n, L, int(n_graphs), n_parts)
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


def _fused_edge_step3_backward_cuda(
    x: torch.Tensor, g_x: torch.Tensor, e: torch.Tensor,
    w_u: torch.Tensor, w_v: torch.Tensor, w_e: torch.Tensor, b0: torch.Tensor,
    w2: torch.Tensor, b2: torch.Tensor,
    receivers: torch.Tensor, edge_gid: torch.Tensor, block_tile: torch.Tensor,
    n_graphs: int, tile: int,
    z_upd: torch.Tensor, dz_upd: torch.Tensor, dr: torch.Tensor, dm: torch.Tensor,
) -> tuple[torch.Tensor, ...]:
    built = cuda_build.library("fused_edge3_bwd")
    floats = (x, g_x, e, w_u, w_v, w_e, b0, w2, b2)
    cots = (z_upd, dz_upd, dr, dm)
    Np, Ep, L, Lp = check_step_inputs("fused_edge_step3_backward", BWD_WIDTHS, tile, (7, 1),
                                      "nsswwwbwbiitssrm", *floats, receivers, edge_gid,
                                      block_tile, *cots)
    # one writer per dx row: each receiver's slots must be one run
    require_consecutive_runs(receivers, Np, "fused_edge_step3_backward")
    if Lp != L:
        out = _fused_edge_step3_backward_cuda(
            *pad_args(floats, "cccwwwcwc", Lp), receivers, edge_gid, block_tile, n_graphs, tile,
            *pad_args(cots, "cccc", Lp))
        return unpad_args(out, "cccwwwcwc", L)
    sd, dev = g_x.dtype, x.device
    transposed = [w.t().contiguous() for w in (w_u, w_v, w_e, w2)]
    # the padding slots after the last real one have zero cotangents in
    # every product: dg and de are zero there, and they add nothing
    n = live_slots(edge_gid, n_graphs, Ep // block_tile.shape[0])
    if wide_strips(L):
        o = wide.backward("fused_edge3_bwd", wide.F3, sd, n, Np, Ep, n_graphs, {
            "na": x, "ga": g_x, "e": e, "wu": w_u, "wv": w_v, "we": w_e, "w2": w2,
            **dict(zip(("wuT", "wvT", "weT", "w2T"), transposed)), "b0": b0, "b2": b2,
            "z_upd": z_upd, "dz": dz_upd, "dr": dr, "dm": dm, "rcv": receivers,
            "gid": edge_gid})
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
    cuda_build.launch("fused_edge3_bwd", "pdg_fused_edge3_bwd", int(sd == torch.bfloat16),
                      x, g_x, e, z_upd, dz_upd, dr, dm, receivers, edge_gid, w_u, w_v, w_e, w2,
                      *transposed, b0, b2, dg, de, dx, scratch, wsplit, wfma, bpart, wpart, wb,
                      Np, n, L, int(n_graphs), n_chunks)
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
    (``cuda_build.launches["fused_edge3_bwd"]`` counts its launches), which
    takes any L (64, 128 and 256 natively, another L <= 256 zero-padded to
    the next, a wider one in the wide variant) and each receiver's slots
    consecutive (the receiver-major layout; a pair-blocked batch's is not)
    and raises otherwise; CPU tensors go to the plain version; anything
    else raises."""
    edge_gid, block_tile = aux
    args = (x, g_x, e, w_u, w_v, w_e, b0, w2, b2, receivers)
    cots = (z_upd, dz_upd, dr, dm)
    if cuda_build.device_kind("fused_edge_step3_backward", *args, *cots, edge_gid,
                              block_tile) == "cuda":
        return _fused_edge_step3_backward_cuda(
            *args, edge_gid, block_tile, n_graphs, tile, *cots)
    return fused_edge_step3_backward_reference(*args, edge_gid, n_graphs, *cots)


def _fused_edge_step3_forward(
    x, g_x, e, w_u, w_v, w_e, b0, w2, b2, receivers, edge_gid, block_tile, n_graphs, tile
):
    args = (x, g_x, e, w_u, w_v, w_e, b0, w2, b2, receivers)
    if cuda_build.device_kind("fused_edge_step3", *args, edge_gid, block_tile) == "cuda":
        return _fused_edge_step3_cuda(*args, edge_gid, block_tile, n_graphs, tile)
    return fused_edge_step3_reference(*args, edge_gid, n_graphs)


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
    the weights. CUDA tensors go to the kernels (``cuda_build.launches``
    counts them under ``fused_edge3_fwd`` and ``fused_edge3_bwd``), which
    take each receiver's slots consecutive (the receiver-major layout; a
    pair-blocked batch's is not) and any L (64, 128 and 256 natively,
    another L <= 256 zero-padded to the next, a wider one in the wide
    variant, ``ops/wide.py``; the padding is exact: ``ops/widths.py``), and
    raise otherwise; CPU tensors go to the plain versions; anything else
    raises."""
    edge_gid, block_tile = aux
    return _FusedEdgeStep3.apply(x, g_x, e, w_u, w_v, w_e, b0, w2, b2, receivers, edge_gid,
                                 block_tile, n_graphs, tile)
