"""Fused edge-step v2, the pair-blocked fused2 step and the lazy graph-LN
helpers — the counterparts of ``p_div_gnn_tpu/ops/fused_edge.py``:
``fused_edge_step`` (whose forward is the Pallas kernel ``_step_kernel`` and
whose VJP is the Pallas kernel ``_step_bwd_kernel``), ``fused_edge_step2``
(``_step2_kernel`` and ``_step2_bwd_kernel``, `:588-955`),
``moments_from_partials`` and ``lazy_layernorm_affine`` (`:547-597`).

For each edge slot i with receiver r, given the hoisted node projections
a_u = x·Wu, a_v = x·Wv and their sender gathers g_v = a_v[snd],
g_u = a_u[snd] (the reference Processor, `models.py:182-243`):

    ep      = e[i]·We                       (shared by both evaluations)
    z_msg   = relu(relu(((a_u[r] + g_v[i]) + ep) + b0)·W2 + b2) · mask_i
    z_upd   = relu(relu(((a_v[r] + g_u[i]) + ep) + b0)·W2 + b2) · mask_i

Returns z_upd (Ep, L) in the stream dtype, R (Np, L) fp32 with
R[r] = Σ z_msg over the edges into r, and M (8, L) fp32 holding
Σz_msg, Σz_msg², Σz_upd, Σz_upd² and four zero rows. A slot is padding
(mask 0) where ``edge_gid >= n_graphs``. The first-layer sum is grouped as
the plain ``"xla"`` Processor groups it (the JAX kernel adds ``ep + b0``
first); both agree to one rounding.

``fused_edge_step`` is an ``autograd.Function``. Its forward runs the
hand-written CUDA kernel (``csrc/fused_edge_fwd.cu``) for CUDA tensors and
the plain PyTorch version ``fused_edge_step_reference`` for CPU tensors; its
backward, ``fused_edge_step_backward``, runs ``csrc/fused_edge_bwd.cu`` or
the plain ``fused_edge_step_backward_reference`` the same way. There is no
fallback from a kernel to a plain version. In bf16 stream mode all of them
round where the JAX package rounds: bf16 operands with fp32 accumulation in
every contraction, ``relu(pre)`` rounded to bf16 before ``·W2``, R and
dA summing bf16-rounded rows, M the fp32 z. The receiver-side cotangent dR
is gathered unrounded, as the JAX op does on the CPU. Each gradient is
returned in its input's dtype, as the JAX VJP (``_step_bwd``) returns it.

``fused_edge_step2`` computes the same step on the pair-blocked layout
(``graphs/batching.py::blockify_edges_pair``), where every block's slots
have their receivers in one node tile and their senders in another: both
endpoint rows are read from the node projections inside the kernel
(``csrc/fused_edge2_fwd.cu``), so there are no streamed sender gathers. Its
backward kernel (``csrc/fused_edge2_bwd.cu``) emits the dpre1 and dpre2
streams, and one pair segment sum over the batch's sender view
(``ops/scatter_csr.py::csr_segment_sum_pair``) adds them per sender, as the
JAX VJP adds them outside its kernel. The same dispatch holds: CUDA
tensors reach the kernels or an error, CPU tensors the plain versions. In
bf16 mode the backward rounds as ``_step2_bwd_kernel`` does, which casts
both operands of every contraction: unlike the v2 backward, the gathered dR
row is rounded to bf16 too.

The fused graph-LN that follows in the reference (`models.py:199,207`) is
folded into its consumers as a per-lane affine, ``LN(z) = z·alpha + beta``
on real rows, from the moment partials M.
"""

from __future__ import annotations

import torch

from p_div_gnn_tpu_torch.ops import cuda_build, wide
from p_div_gnn_tpu_torch.ops.cuda_build import CudaLibrary
from p_div_gnn_tpu_torch.ops.scatter_csr import csr_segment_sum_pair
from p_div_gnn_tpu_torch.ops.segment import (
    live_slots,
    require_consecutive_runs,
    segment_sum,
    slot_outputs,
)
from p_div_gnn_tpu_torch.ops.widths import pad_args, padded_width, unpad_args, wide_strips
from p_div_gnn_tpu_torch.parallel.collectives import Group, psum64

STREAM_DTYPES = (torch.float32, torch.bfloat16)
# the widths the tile kernels are built for (fused3_tile.cuh's register
# tile): the forwards (#5, #7) and the backwards (#6, #8) take 64, 128 and
# 256; any other L <= 256 runs at the next one, zero-padded, and a wider L
# at the wide variant (ops/widths.py)
FWD_WIDTHS = (64, 128, 256)
BWD_WIDTHS = (64, 128, 256)


def moments_from_partials(
    m_sum: torch.Tensor, m_sumsq: torch.Tensor, edge_mask: torch.Tensor,
    group: Group | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Whole-tensor mean/std from per-lane partial sums (padding rows
    contribute exactly 0). Under sharding (``group``) the count and the two
    sums are summed over the ranks in fp64, so the graph-LN spans the whole
    batch."""
    L = m_sum.shape[-1]
    count, total, total_sq = psum64(
        torch.stack([edge_mask.to(m_sum.dtype).sum() * L, m_sum.sum(), m_sumsq.sum()]), group)
    count = torch.clamp(count, min=1.0)
    mean = total / count
    # One-pass variance E[z²] − mean² can cancel to ≤ 0 in fp32; the 1e-12
    # floor is far below any healthy variance and keeps sqrt finite.
    var = torch.clamp(total_sq / count - mean * mean, min=1e-12)
    return mean, torch.sqrt(var)


def lazy_layernorm_affine(
    mean: torch.Tensor,
    std: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    eps: float = 1e-5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold graph-LN into per-lane (alpha, beta)."""
    alpha = weight / (std + eps)
    return alpha, bias - mean * alpha


# the tensors of a fused edge step's call, by their letter in
# check_step_inputs' spec: dtype (None: the stream dtype), name, shape
_STEP_TENSORS = {
    "n": (None, "node rows", "(Np, L)"), "s": (None, "slot streams", "(Ep, L)"),
    "w": (None, "weights", "(L, L)"), "b": (None, "biases", "(L,)"),
    "i": (torch.int32, "slot indices", "(Ep,)"), "t": (torch.int32, "block tile arrays", "(NB,)"),
    "r": (torch.float32, "dR", "(Np, L)"), "m": (torch.float32, "dM", "(8, L)"),
}


def check_step_inputs(who: str, widths: tuple[int, ...], tile: int, rows: tuple[int, int],
                      spec: str, *tensors: torch.Tensor) -> tuple[int, int, int, int]:
    """The input contract of the six fused edge-step kernels (#1, #2,
    #5-#8): dtype, device, contiguity and shape of each tensor, and the
    layout, of a call built for ``widths``. Each tensor's letter in
    ``spec`` says what it is: "n" node rows (Np, L), "s" a slot stream
    (Ep, L), "w" a weight (L, L), "b" a bias (L,), "i" an int32 slot index
    (Ep,), "t" an int32 block tile array (NB,), one entry a block of slots,
    "r" dR (Np, L) and "m" dM (8, L), both fp32. The first node rows give
    (Np, L), the first slot stream Ep and the stream dtype, the first block
    tile array NB. ``rows`` = (per slot, per node): the most rows of Lp
    values the kernel indexes with 32 bits, per edge slot and per node.
    Returns (Np, Ep, L, Lp), Lp the width it runs at."""
    def refuse(msg: str) -> None:
        raise ValueError(f"{who}: {msg}")

    Np, L = tensors[spec.index("n")].shape
    slots = tensors[spec.index("s")]
    Ep, sd = slots.shape[0], slots.dtype
    n_blocks = tensors[spec.index("t")].shape[0]
    if sd not in STREAM_DTYPES:
        refuse(f"stream dtype {sd} is not float32 or bfloat16")
    shapes = {"n": (Np, L), "s": (Ep, L), "w": (L, L), "b": (L,), "i": (Ep,), "t": (n_blocks,),
              "r": (Np, L), "m": (8, L)}
    dev = slots.device
    for t, c in zip(tensors, spec, strict=True):
        dtype, name, shape = _STEP_TENSORS[c]
        if t.dtype != (dtype or sd):
            refuse(f"{name} must be {dtype or sd}" + ("" if dtype else ", the stream dtype"))
        if t.device != dev:
            refuse("tensors on several devices")
        if not t.is_contiguous():
            refuse("tensors must be contiguous")
        if t.shape != shapes[c]:
            refuse(f"{name} must be {shape}")
    if n_blocks < 1 or Ep % n_blocks:
        refuse("edge slots must split into whole blocks")
    if tile < 1 or Np % tile:
        refuse(f"Np={Np} is not a multiple of tile={tile}")
    Lp = padded_width(L, widths, who)
    per_slot, per_node = rows
    if not (wide_strips(Lp) or (per_slot * Ep * Lp < 2**31 and per_node * Np * Lp < 2**31)):
        refuse("arrays too large")
    return Np, Ep, L, Lp


def forward_scratch(built: CudaLibrary, name: str, sd: torch.dtype, L: int, dev: torch.device,
                    n_wfma: int) -> tuple:
    """A forward's scratch (#1, #5, #7): (n_parts, wfma or None, mpart);
    n_parts is the persistent grid's CTAs, one per SM of the device, and
    wfma the (n_wfma, L, L) fp32 weights of the FMA chains, where the
    kernel takes them."""
    with torch.cuda.device(dev):
        n_parts = int(getattr(built.lib, f"pdg_{name}_parts")())
    if n_parts < 1:
        raise RuntimeError(f"{name}: cannot read the card's SM count")
    wfma = None
    if getattr(built.lib, f"pdg_{name}_needs_wfma")(int(sd == torch.bfloat16), L):
        wfma = torch.empty((n_wfma, L, L), dtype=torch.float32, device=dev)
    mpart = torch.empty((n_parts, 4, L), dtype=torch.float64, device=dev)
    return n_parts, wfma, mpart


def fused_edge_step_reference(
    a_u: torch.Tensor, a_v: torch.Tensor, g_v: torch.Tensor, g_u: torch.Tensor,
    e: torch.Tensor, w_e: torch.Tensor, b0: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
    receivers: torch.Tensor, edge_gid: torch.Tensor, n_graphs: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: gathers, matmuls and ``segment_sum``."""
    sd = g_v.dtype
    we, b0f, w2f, b2f = (t.float() for t in (w_e, b0, w2, b2))
    ep = e.float() @ we
    mask = (edge_gid < n_graphs).float()[:, None]

    def edge_mlp(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        pre = ((a.float().index_select(0, receivers) + g.float()) + ep) + b0f
        h = torch.relu(pre).to(sd).float()
        return torch.relu(h @ w2f + b2f) * mask

    z_msg = edge_mlp(a_u, g_v)
    z_upd = edge_mlp(a_v, g_u)
    r = segment_sum(z_msg.to(sd).float(), receivers, a_u.shape[0])
    # moment sums in fp64, rounded once, as the kernel takes them
    zm, zu = z_msg.double(), z_upd.double()
    m = torch.zeros((8, a_u.shape[1]), dtype=torch.float64, device=a_u.device)
    m[0], m[1], m[2], m[3] = zm.sum(0), (zm * zm).sum(0), zu.sum(0), (zu * zu).sum(0)
    return z_upd.to(sd), r, m.float()


def _fused_edge_step_cuda(
    a_u: torch.Tensor, a_v: torch.Tensor, g_v: torch.Tensor, g_u: torch.Tensor,
    e: torch.Tensor, w_e: torch.Tensor, b0: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
    receivers: torch.Tensor, edge_gid: torch.Tensor, block_tile: torch.Tensor,
    n_graphs: int, tile: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    built = cuda_build.library("fused_edge_fwd")
    floats = (a_u, a_v, g_v, g_u, e, w_e, b0, w2, b2)
    Np, Ep, L, Lp = check_step_inputs("fused_edge_step", FWD_WIDTHS, tile, (5, 2), "nnssswbwbiit",
                                      *floats, receivers, edge_gid, block_tile)
    # one writer per R row: each receiver's slots must be one run
    require_consecutive_runs(receivers, Np, "fused_edge_step")
    if Lp != L:
        out = _fused_edge_step_cuda(*pad_args(floats, "cccccwcwc", Lp), receivers, edge_gid,
                                    block_tile, n_graphs, tile)
        return unpad_args(out, "ccc", L)
    sd, dev = g_v.dtype, a_u.device
    # the kernel runs the slots up to the last real one; the padding after
    # them has zero z_upd, messages and moments
    n = live_slots(edge_gid, n_graphs, Ep // block_tile.shape[0])
    if wide_strips(L):
        return wide.forward("fused_edge_fwd", sd, n, Np, Ep, n_graphs, {
            "na": a_u, "nb": a_v, "ga": g_v, "gb": g_u, "e": e, "we": w_e, "w2": w2, "b0": b0,
            "b2": b2, "rcv": receivers, "gid": edge_gid})
    (z_upd,) = slot_outputs(n, 1, Ep, L, sd, dev)
    r = torch.empty((Np, L), dtype=torch.float32, device=dev)  # zeroed by the launch
    m = torch.empty((8, L), dtype=torch.float32, device=dev)
    n_parts, wfma, mpart = forward_scratch(built, "fused_edge_fwd", sd, L, dev, 2)
    cuda_build.launch("fused_edge_fwd", "pdg_fused_edge_fwd", int(sd == torch.bfloat16),
                      a_u, a_v, g_v, g_u, e, receivers, edge_gid, w_e, w2, b0, b2, z_upd, r,
                      wfma, mpart, m, Np, n, L, int(n_graphs), n_parts)
    return z_upd, r, m


def fused_edge_step_backward_reference(
    a_u: torch.Tensor, a_v: torch.Tensor, g_v: torch.Tensor, g_u: torch.Tensor,
    e: torch.Tensor, w_e: torch.Tensor, b0: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
    receivers: torch.Tensor, edge_gid: torch.Tensor, n_graphs: int,
    z_upd: torch.Tensor, dz_upd: torch.Tensor, dr: torch.Tensor, dm: torch.Tensor,
) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the backward (``_step_bwd_kernel``): z_msg
    is recomputed (re-masked before its gate), z_upd is the forward's.
    Returns (da_u, da_v, dg_v, dg_u, de, dWe, db0, dW2, db2): dg_v = dpre1,
    dg_u = dpre2 and de in the stream dtype, the rest fp32. The weight
    grads sum over every slot in fp64 and round once: the exact sums of the
    products, which the kernel's fp32 products (summed in fp32 over 8
    slots, then in fp64) approach to their rounding."""
    sd = g_v.dtype
    Np = a_u.shape[0]

    def rnd(t: torch.Tensor) -> torch.Tensor:  # round through the stream dtype
        return t.to(sd).float()

    def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return rnd(a) @ rnd(b)

    def wsum(*pairs: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        return sum(rnd(a).double().T @ rnd(b).double() for a, b in pairs).float()

    we, w2f = w_e.float(), w2.float()
    # the cotangent products read contiguous transposes, as the kernel does
    weT, w2T = we.T.contiguous(), w2f.T.contiguous()
    b0f, b2f = b0.float(), b2.float()
    mask = (edge_gid < n_graphs).float()[:, None]
    ef = e.float()
    ep = mm(ef, we)
    pre1 = ((a_u.float().index_select(0, receivers) + g_v.float()) + ep) + b0f
    pre2 = ((a_v.float().index_select(0, receivers) + g_u.float()) + ep) + b0f
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

    de = mm(dps, weT).to(sd)
    da_u = segment_sum(rnd(dpre1), receivers, Np)
    da_v = segment_sum(rnd(dpre2), receivers, Np)
    dw2 = wsum((h1, dy1), (h2, dy2))
    dwe = wsum((ef, dps))
    db2 = (dy1 + dy2).double().sum(0).float()
    db0 = dps.double().sum(0).float()
    return da_u, da_v, dpre1.to(sd), dpre2.to(sd), de, dwe, db0, dw2, db2


def _fused_edge_step_backward_cuda(
    a_u: torch.Tensor, a_v: torch.Tensor, g_v: torch.Tensor, g_u: torch.Tensor,
    e: torch.Tensor, w_e: torch.Tensor, b0: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
    receivers: torch.Tensor, edge_gid: torch.Tensor, block_tile: torch.Tensor,
    n_graphs: int, tile: int,
    z_upd: torch.Tensor, dz_upd: torch.Tensor, dr: torch.Tensor, dm: torch.Tensor,
) -> tuple[torch.Tensor, ...]:
    built = cuda_build.library("fused_edge_bwd")
    floats = (a_u, a_v, g_v, g_u, e, w_e, b0, w2, b2)
    cots = (z_upd, dz_upd, dr, dm)
    Np, Ep, L, Lp = check_step_inputs("fused_edge_step_backward", BWD_WIDTHS, tile, (5, 2),
                                      "nnssswbwbiitssrm", *floats, receivers, edge_gid,
                                      block_tile, *cots)
    # one writer per da row: each receiver's slots must be one run
    require_consecutive_runs(receivers, Np, "fused_edge_step_backward")
    if Lp != L:
        out = _fused_edge_step_backward_cuda(
            *pad_args(floats, "cccccwcwc", Lp), receivers, edge_gid, block_tile, n_graphs, tile,
            *pad_args(cots, "cccc", Lp))
        return unpad_args(out, "cccccwcwc", L)
    sd, dev = g_v.dtype, a_u.device
    weT, w2T = w_e.t().contiguous(), w2.t().contiguous()
    # the padding slots after the last real one have zero cotangents in
    # every product: dg_v, dg_u and de are zero there, and they add nothing
    n = live_slots(edge_gid, n_graphs, Ep // block_tile.shape[0])
    if wide_strips(L):
        o = wide.backward("fused_edge_bwd", wide.V2, sd, n, Np, Ep, n_graphs, {
            "na": a_u, "nb": a_v, "ga": g_v, "gb": g_u, "e": e, "we": w_e, "w2": w2,
            "weT": weT, "w2T": w2T, "b0": b0, "b2": b2, "z_upd": z_upd, "dz": dz_upd,
            "dr": dr, "dm": dm, "rcv": receivers, "gid": edge_gid})
        dw2, dwe = o["w_out"].unbind(0)
        return (o["r_out"], o["r_out2"], o["dg1"], o["dg2"], o["de"], dwe, o["m_out"][1], dw2,
                o["m_out"][0])
    dg_v, dg_u, de = slot_outputs(n, 3, Ep, L, sd, dev)
    da = torch.zeros((2, Np, L), dtype=torch.float32, device=dev)
    scratch = torch.empty((5, n, L), dtype=sd, device=dev)
    # We, W2, W2ᵀ in fp32 for the FMA chains; Weᵀ as bf16 terms for the
    # tensor cores, 3 in fp32 mode
    wfma = torch.empty((3, L, L), dtype=torch.float32, device=dev)
    n_terms = 1 if sd == torch.bfloat16 else 3
    wsplit = torch.empty((1, n_terms, L, L), dtype=torch.int16, device=dev)
    bpart = torch.empty((built.lib.pdg_fused_edge_bwd_parts(n), 2, L), dtype=torch.float64,
                        device=dev)
    # weight-grad partial sums: slots are cut into chunks, each summed by
    # CTAs of 64 rows of dW2 or dWe
    n_chunks = built.lib.pdg_fused_edge_bwd_chunks(n)
    wpart = torch.empty((n_chunks, 2, L, L), dtype=torch.float64, device=dev)
    wb = torch.empty((2 * L + 2, L), dtype=torch.float32, device=dev)
    cuda_build.launch("fused_edge_bwd", "pdg_fused_edge_bwd", int(sd == torch.bfloat16),
                      a_u, a_v, g_v, g_u, e, z_upd, dz_upd, dr, dm, receivers, edge_gid, w_e, w2,
                      w2T, weT, b0, b2, dg_v, dg_u, de, da, scratch, wfma, wsplit, bpart, wpart,
                      wb, Np, n, L, int(n_graphs), n_chunks)
    dw2, dwe = wb[:2 * L].view(2, L, L).unbind(0)
    return da[0], da[1], dg_v, dg_u, de, dwe, wb[2 * L + 1], dw2, wb[2 * L]


def fused_edge_step_backward(
    a_u: torch.Tensor, a_v: torch.Tensor, g_v: torch.Tensor, g_u: torch.Tensor,
    e: torch.Tensor, w_e: torch.Tensor, b0: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
    receivers: torch.Tensor, aux: tuple[torch.Tensor, torch.Tensor], n_graphs: int,
    tile: int,
    z_upd: torch.Tensor,  # (Ep, L) the forward's output, stream dtype
    dz_upd: torch.Tensor,  # (Ep, L) cotangents, stream dtype
    dr: torch.Tensor,  # (Np, L) fp32
    dm: torch.Tensor,  # (8, L) fp32
) -> tuple[torch.Tensor, ...]:
    """The v2 edge step's VJP: (da_u, da_v, dg_v, dg_u, de, dWe, db0, dW2,
    db2), dg_v, dg_u and de in the stream dtype, the rest fp32. CUDA
    tensors go to the kernel (``cuda_build.launches["fused_edge_bwd"]``
    counts its launches), which takes any L (64, 128 and 256 natively,
    another L <= 256 zero-padded to the next, a wider one in the wide
    variant) and each receiver's slots consecutive (the receiver-major
    layout; a pair-blocked batch's is not) and raises otherwise; CPU
    tensors go to the plain version; anything else raises."""
    edge_gid, block_tile = aux
    args = (a_u, a_v, g_v, g_u, e, w_e, b0, w2, b2, receivers)
    cots = (z_upd, dz_upd, dr, dm)
    if cuda_build.device_kind("fused_edge_step_backward", *args, *cots, edge_gid,
                              block_tile) == "cuda":
        return _fused_edge_step_backward_cuda(
            *args, edge_gid, block_tile, n_graphs, tile, *cots)
    return fused_edge_step_backward_reference(*args, edge_gid, n_graphs, *cots)


def _fused_edge_step_forward(
    a_u, a_v, g_v, g_u, e, w_e, b0, w2, b2, receivers, edge_gid, block_tile, n_graphs, tile
):
    args = (a_u, a_v, g_v, g_u, e, w_e, b0, w2, b2, receivers)
    if cuda_build.device_kind("fused_edge_step", *args, edge_gid, block_tile) == "cuda":
        return _fused_edge_step_cuda(*args, edge_gid, block_tile, n_graphs, tile)
    return fused_edge_step_reference(*args, edge_gid, n_graphs)


class _FusedEdgeStep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a_u, a_v, g_v, g_u, e, w_e, b0, w2, b2, receivers, edge_gid, block_tile,
                n_graphs, tile):
        z_upd, r, m = _fused_edge_step_forward(
            a_u, a_v, g_v, g_u, e, w_e, b0, w2, b2, receivers, edge_gid, block_tile,
            n_graphs, tile)
        # what the JAX VJP saves (`_step_fwd`): the inputs and z_upd
        ctx.save_for_backward(a_u, a_v, g_v, g_u, e, w_e, b0, w2, b2, receivers, edge_gid,
                              block_tile, z_upd)
        ctx.n_graphs, ctx.tile = n_graphs, tile
        return z_upd, r, m

    @staticmethod
    def backward(ctx, dz_upd, dr, dm):
        (a_u, a_v, g_v, g_u, e, w_e, b0, w2, b2, receivers, edge_gid, block_tile,
         z_upd) = ctx.saved_tensors
        grads = fused_edge_step_backward(
            a_u, a_v, g_v, g_u, e, w_e, b0, w2, b2, receivers, (edge_gid, block_tile),
            ctx.n_graphs, ctx.tile, z_upd, dz_upd.contiguous(), dr.contiguous(),
            dm.contiguous())
        inputs = (a_u, a_v, g_v, g_u, e, w_e, b0, w2, b2)
        return (*(gr.to(t.dtype) for gr, t in zip(grads, inputs)),) + (None,) * 5


def fused_edge_step(
    a_u: torch.Tensor,  # (Np, L) receiver-slot projection for the messages, x·Wu
    a_v: torch.Tensor,  # (Np, L) receiver-slot projection for the edge update, x·Wv
    g_v: torch.Tensor,  # (Ep, L) sender gather of x·Wv (message path)
    g_u: torch.Tensor,  # (Ep, L) sender gather of x·Wu (edge-update path)
    e: torch.Tensor,  # (Ep, L) raw edge latents (projected in the kernel)
    w_e: torch.Tensor,  # (L, L) edge-slot first-layer weight
    b0: torch.Tensor,  # (L,)
    w2: torch.Tensor,  # (L, L)
    b2: torch.Tensor,  # (L,)
    receivers: torch.Tensor,  # (Ep,) i32, block-aligned CSR
    aux: tuple[torch.Tensor, torch.Tensor],  # (edge_gid (Ep,), block_tile (NB,))
    n_graphs: int,
    tile: int,  # node tile of the layout (GraphBatch.tile)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The v2 edge step: (z_upd, R, M), differentiable in a_u, a_v, g_v,
    g_u, e and the weights. CUDA tensors go to the kernels
    (``cuda_build.launches`` counts them under ``fused_edge_fwd`` and
    ``fused_edge_bwd``), which take any
    L (64, 128 and 256 natively, another L <= 256 zero-padded to the next,
    a wider one in the wide variant) and each receiver's slots consecutive
    (the receiver-major layout; a pair-blocked batch's is not) and raise
    otherwise; CPU tensors go to the plain versions; anything else raises."""
    edge_gid, block_tile = aux
    return _FusedEdgeStep.apply(a_u, a_v, g_v, g_u, e, w_e, b0, w2, b2, receivers, edge_gid,
                                block_tile, n_graphs, tile)


# ---------------------------------------------------------------------------
# fused2: the pair-blocked edge step (`fused_edge.py:588-955` of the JAX
# package)
# ---------------------------------------------------------------------------

PairAux = tuple  # (edge_gid, block_tile, block_snd_tile[, snd_perm, snd_sorted, snd_block_tile])


def _pair_in_tile(
    receivers: torch.Tensor, senders: torch.Tensor, block_tile: torch.Tensor,
    block_snd_tile: torch.Tensor, tile: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(Ep, 1) masks: the slot's receiver lies in its block's receiver tile,
    its sender in its block's sender tile. Outside, the TPU kernel's one-hot
    contractions read zero."""
    Ep = receivers.shape[0]
    slot_block = torch.arange(Ep, device=receivers.device) // (Ep // block_tile.shape[0])
    in_r = torch.div(receivers, tile, rounding_mode="floor") == block_tile[slot_block]
    in_s = torch.div(senders, tile, rounding_mode="floor") == block_snd_tile[slot_block]
    return in_r[:, None], in_s[:, None]


def fused_edge_step2_reference(
    proj_u: torch.Tensor, proj_v: torch.Tensor, e: torch.Tensor, w_e: torch.Tensor,
    b0: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor, receivers: torch.Tensor,
    senders: torch.Tensor, aux: PairAux, n_graphs: int, tile: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the pair-blocked forward (``_step2_kernel``):
    gathers at both endpoints (zero outside the block's tiles), matmuls and
    ``segment_sum``."""
    edge_gid, block_tile, block_snd_tile = aux[:3]
    sd = e.dtype
    Np = proj_u.shape[0]
    in_r, in_s = _pair_in_tile(receivers, senders, block_tile, block_snd_tile, tile)
    we, b0f, w2f, b2f = (t.float() for t in (w_e, b0, w2, b2))
    ep = e.float() @ we
    mask = (edge_gid < n_graphs).float()[:, None]

    def edge_mlp(a: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        a_r = torch.where(in_r, a.float().index_select(0, receivers), 0.0)
        p_s = torch.where(in_s, p.float().index_select(0, senders), 0.0)
        h = torch.relu(((a_r + p_s) + ep) + b0f).to(sd).float()
        return torch.relu(h @ w2f + b2f) * mask

    z_msg = edge_mlp(proj_u, proj_v)  # messages: u at the receiver, v at the sender
    z_upd = edge_mlp(proj_v, proj_u)  # edge update: v at the receiver, u at the sender
    r = segment_sum(torch.where(in_r, z_msg.to(sd).float(), 0.0), receivers, Np)
    zm, zu = z_msg.double(), z_upd.double()
    m = torch.zeros((8, proj_u.shape[1]), dtype=torch.float64, device=proj_u.device)
    m[0], m[1], m[2], m[3] = zm.sum(0), (zm * zm).sum(0), zu.sum(0), (zu * zu).sum(0)
    return z_upd.to(sd), r, m.float()


def _fused_edge_step2_cuda(
    proj_u: torch.Tensor, proj_v: torch.Tensor, e: torch.Tensor, w_e: torch.Tensor,
    b0: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor, receivers: torch.Tensor,
    senders: torch.Tensor, edge_gid: torch.Tensor, block_tile: torch.Tensor,
    block_snd_tile: torch.Tensor, n_graphs: int, tile: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    built = cuda_build.library("fused_edge2_fwd")
    floats = (proj_u, proj_v, e, w_e, b0, w2, b2)
    Np, Ep, L, Lp = check_step_inputs("fused_edge_step2", FWD_WIDTHS, tile, (5, 2), "nnswbwbiiitt",
                                      *floats, receivers, senders, edge_gid, block_tile,
                                      block_snd_tile)
    if Lp != L:
        out = _fused_edge_step2_cuda(*pad_args(floats, "cccwcwc", Lp), receivers, senders,
                                     edge_gid, block_tile, block_snd_tile, n_graphs, tile)
        return unpad_args(out, "ccc", L)
    slot, rcv, snd, pad = pair_entries(receivers, senders, edge_gid, block_tile,
                                       block_snd_tile, n_graphs, tile)
    sd, dev = e.dtype, e.device
    if wide_strips(L):
        return wide.forward("fused_edge2_fwd", sd, slot.shape[0], Np, Ep, n_graphs, {
            "na": proj_u, "nb": proj_v, "e": e, "we": w_e, "w2": w2, "b0": b0, "b2": b2,
            "slot": slot, "rcv": rcv, "snd": snd})
    z_upd = torch.empty((Ep, L), dtype=sd, device=dev)
    r = torch.empty((Np, L), dtype=torch.float32, device=dev)  # zeroed by the launch
    m = torch.empty((8, L), dtype=torch.float32, device=dev)
    n_parts, wfma, mpart = forward_scratch(built, "fused_edge2_fwd", sd, L, dev, 2)
    cuda_build.launch("fused_edge2_fwd", "pdg_fused_edge2_fwd", int(sd == torch.bfloat16),
                      proj_u, proj_v, e, slot, rcv, snd, pad, w_e, w2, b0, b2, z_upd, r, wfma,
                      mpart, m, Np, Ep, slot.shape[0], pad.shape[0], L, n_parts)
    return z_upd, r, m


def fused_edge2_bwd_reference(
    proj_u: torch.Tensor, proj_v: torch.Tensor, e: torch.Tensor, w_e: torch.Tensor,
    b0: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor, receivers: torch.Tensor,
    senders: torch.Tensor, aux: PairAux, n_graphs: int, tile: int,
    z_upd: torch.Tensor, dz_upd: torch.Tensor, dr: torch.Tensor, dm: torch.Tensor,
) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch version of ``_step2_bwd_kernel``: z_msg is recomputed,
    z_upd is the forward's (zero on the padding slots). Returns (de, dpre1,
    dpre2, du_r, dv_r, dWe, db0, dW2, db2): de, dpre1 and dpre2 in the
    stream dtype, the rest fp32; du_r and dv_r are the receiver sums of
    dpre1 and dpre2 (slots whose receiver lies in their block's tile). In
    bf16 mode every contraction rounds both operands, as the JAX kernel's
    ``mm`` does: the gathered dR, h, dy and dpre1 + dpre2 before the
    products, dpre1 and dpre2 before the receiver sums. The weight grads
    sum in fp64 and round once."""
    edge_gid, block_tile, block_snd_tile = aux[:3]
    sd = e.dtype
    Np = proj_u.shape[0]
    in_r, in_s = _pair_in_tile(receivers, senders, block_tile, block_snd_tile, tile)

    def rnd(t: torch.Tensor) -> torch.Tensor:  # round through the stream dtype
        return t.to(sd).float()

    def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return rnd(a) @ rnd(b)

    def wsum(*pairs: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        return sum(rnd(a).double().T @ rnd(b).double() for a, b in pairs).float()

    def at(p: torch.Tensor, idx: torch.Tensor, inside: torch.Tensor) -> torch.Tensor:
        return torch.where(inside, p.float().index_select(0, idx), 0.0)

    we, w2f = w_e.float(), w2.float()
    # the cotangent products read contiguous transposes, as the kernel does
    weT, w2T = we.T.contiguous(), w2f.T.contiguous()
    b0f, b2f = b0.float(), b2.float()
    mask = (edge_gid < n_graphs).float()[:, None]
    ef = e.float()
    ep = mm(ef, we)
    pre1 = ((at(proj_u, receivers, in_r) + at(proj_v, senders, in_s)) + ep) + b0f
    pre2 = ((at(proj_v, receivers, in_r) + at(proj_u, senders, in_s)) + ep) + b0f
    h1, h2 = torch.relu(pre1), torch.relu(pre2)
    z_msg = torch.relu(mm(h1, w2f) + b2f) * mask
    z_u = z_upd.float()
    dmf = dm.float()

    dz_msg = at(rnd(dr), receivers, in_r) + dmf[0] + 2.0 * dmf[1] * z_msg
    dy1 = dz_msg * (z_msg > 0)
    dz_u = dz_upd.float() + dmf[2] + 2.0 * dmf[3] * z_u
    dy2 = dz_u * ((z_u > 0) & (mask > 0))
    dpre1 = mm(dy1, w2T) * (h1 > 0)
    dpre2 = mm(dy2, w2T) * (h2 > 0)
    dps = dpre1 + dpre2

    de = mm(dps, weT).to(sd)
    du_r = segment_sum(torch.where(in_r, rnd(dpre1), 0.0), receivers, Np)
    dv_r = segment_sum(torch.where(in_r, rnd(dpre2), 0.0), receivers, Np)
    dw2 = wsum((h1, dy1), (h2, dy2))
    dwe = wsum((ef, dps))
    db2 = (dy1 + dy2).double().sum(0).float()
    db0 = dps.double().sum(0).float()
    return de, dpre1.to(sd), dpre2.to(sd), du_r, dv_r, dwe, db0, dw2, db2


def pair_entries(
    receivers: torch.Tensor, senders: torch.Tensor, edge_gid: torch.Tensor,
    block_tile: torch.Tensor, block_snd_tile: torch.Tensor, n_graphs: int, tile: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The pair-blocked kernels' entries (the forward's and the backward's):
    (slot, rcv, snd) of the real slots, stably sorted by receiver, so each
    receiver's slots are one run of the list in slot order (the layout meets
    a receiver in up to ~4 runs, one per sender tile of its receiver tile);
    rcv and snd are -1 where the endpoint lies outside its block's tile (the
    layout never makes one). Then the padding slots. int32, on the layout's
    device; kept on ``edge_gid`` for the layout's later calls (one device
    sync per layout)."""
    key = tuple((t.data_ptr(), t._version) for t in
                (receivers, senders, edge_gid, block_tile, block_snd_tile)) + (n_graphs, tile)
    cached = getattr(edge_gid, "_pdg_pair_entries", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    in_r, in_s = _pair_in_tile(receivers, senders, block_tile, block_snd_tile, tile)
    real = edge_gid < n_graphs
    rcv = torch.where(in_r[:, 0], receivers, -1)
    snd = torch.where(in_s[:, 0], senders, -1)
    slots = torch.nonzero(real).flatten()
    slots = slots[torch.sort(rcv[slots], stable=True).indices]
    entries = (slots.int(), rcv[slots].int(), snd[slots].int(),
               torch.nonzero(~real).flatten().int())
    edge_gid._pdg_pair_entries = (key, entries)
    return entries


def _fused_edge2_bwd_cuda(
    proj_u: torch.Tensor, proj_v: torch.Tensor, e: torch.Tensor, w_e: torch.Tensor,
    b0: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor, receivers: torch.Tensor,
    senders: torch.Tensor, edge_gid: torch.Tensor, block_tile: torch.Tensor,
    block_snd_tile: torch.Tensor, n_graphs: int, tile: int,
    z_upd: torch.Tensor, dz_upd: torch.Tensor, dr: torch.Tensor, dm: torch.Tensor,
) -> tuple[torch.Tensor, ...]:
    built = cuda_build.library("fused_edge2_bwd")
    floats = (proj_u, proj_v, e, w_e, b0, w2, b2)
    cots = (z_upd, dz_upd, dr, dm)
    Np, Ep, L, Lp = check_step_inputs("fused_edge2_bwd", BWD_WIDTHS, tile, (5, 2),
                                      "nnswbwbiiittssrm", *floats, receivers, senders, edge_gid,
                                      block_tile, block_snd_tile, *cots)
    if Lp != L:
        out = _fused_edge2_bwd_cuda(
            *pad_args(floats, "cccwcwc", Lp), receivers, senders, edge_gid, block_tile,
            block_snd_tile, n_graphs, tile, *pad_args(cots, "cccc", Lp))
        return unpad_args(out, "cccccwcwc", L)
    slot, rcv, snd, pad = pair_entries(receivers, senders, edge_gid, block_tile,
                                       block_snd_tile, n_graphs, tile)
    n_real = slot.shape[0]
    sd, dev = e.dtype, e.device
    weT, w2T = w_e.t().contiguous(), w2.t().contiguous()
    if wide_strips(L):
        o = wide.backward("fused_edge2_bwd", wide.P2, sd, n_real, Np, Ep, n_graphs, {
            "na": proj_u, "nb": proj_v, "e": e, "we": w_e, "w2": w2, "weT": weT, "w2T": w2T,
            "b0": b0, "b2": b2, "z_upd": z_upd, "dz": dz_upd, "dr": dr, "dm": dm,
            "slot": slot, "rcv": rcv, "snd": snd})
        dw2, dwe = o["w_out"].unbind(0)
        return (o["de"], o["dg1"], o["dg2"], o["r_out"], o["r_out2"], dwe, o["m_out"][1], dw2,
                o["m_out"][0])
    dpre1 = torch.empty((Ep, L), dtype=sd, device=dev)
    dpre2 = torch.empty((Ep, L), dtype=sd, device=dev)
    de = torch.empty((Ep, L), dtype=sd, device=dev)
    dur = torch.zeros((2, Np, L), dtype=torch.float32, device=dev)
    scratch = torch.empty((5, n_real, L), dtype=sd, device=dev)
    wfma = torch.empty((3, L, L), dtype=torch.float32, device=dev)
    n_terms = 1 if sd == torch.bfloat16 else 3
    wsplit = torch.empty((1, n_terms, L, L), dtype=torch.int16, device=dev)
    bpart = torch.empty((built.lib.pdg_fused_edge2_bwd_parts(n_real), 2, L),
                        dtype=torch.float64, device=dev)
    n_chunks = built.lib.pdg_fused_edge2_bwd_chunks(n_real)
    wpart = torch.empty((n_chunks, 2, L, L), dtype=torch.float64, device=dev)
    wb = torch.empty((2 * L + 2, L), dtype=torch.float32, device=dev)
    cuda_build.launch("fused_edge2_bwd", "pdg_fused_edge2_bwd", int(sd == torch.bfloat16),
                      proj_u, proj_v, e, z_upd, dz_upd, dr, dm, slot, rcv, snd, pad, w_e, w2,
                      w2T, weT, b0, b2, dpre1, dpre2, de, dur, scratch, wfma, wsplit, bpart,
                      wpart, wb, Np, Ep, n_real, pad.shape[0], L, n_chunks)
    dw2, dwe = wb[:2 * L].view(2, L, L).unbind(0)
    return de, dpre1, dpre2, dur[0], dur[1], dwe, wb[2 * L + 1], dw2, wb[2 * L]


def fused_edge2_bwd(
    proj_u: torch.Tensor, proj_v: torch.Tensor, e: torch.Tensor, w_e: torch.Tensor,
    b0: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor, receivers: torch.Tensor,
    senders: torch.Tensor, aux: PairAux, n_graphs: int, tile: int,
    z_upd: torch.Tensor, dz_upd: torch.Tensor, dr: torch.Tensor, dm: torch.Tensor,
) -> tuple[torch.Tensor, ...]:
    """The pair-blocked backward kernel's outputs (de, dpre1, dpre2, du_r,
    dv_r, dWe, db0, dW2, db2), before the sender-side sums. CUDA tensors go
    to the kernel (``cuda_build.launches["fused_edge2_bwd"]`` counts its
    launches), which
    takes any L (64, 128 and 256 natively, another L <= 256 zero-padded to
    the next, a wider one in the wide variant), CPU tensors to
    ``fused_edge2_bwd_reference``; anything else raises."""
    edge_gid, block_tile, block_snd_tile = aux[:3]
    args = (proj_u, proj_v, e, w_e, b0, w2, b2, receivers, senders)
    cots = (z_upd, dz_upd, dr, dm)
    if cuda_build.device_kind("fused_edge2_bwd", *args, *cots, edge_gid, block_tile,
                              block_snd_tile) == "cuda":
        return _fused_edge2_bwd_cuda(*args, edge_gid, block_tile, block_snd_tile, n_graphs,
                                     tile, *cots)
    return fused_edge2_bwd_reference(*args, aux, n_graphs, tile, *cots)


def fused_edge_step2_backward_reference(
    proj_u: torch.Tensor, proj_v: torch.Tensor, e: torch.Tensor, w_e: torch.Tensor,
    b0: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor, receivers: torch.Tensor,
    senders: torch.Tensor, aux: PairAux, n_graphs: int, tile: int,
    z_upd: torch.Tensor, dz_upd: torch.Tensor, dr: torch.Tensor, dm: torch.Tensor,
) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the whole VJP (``_step2_bwd``): (du, dv, de,
    dWe, db0, dW2, db2) with du = du_r + S(dpre2) and dv = dv_r + S(dpre1),
    S the fp32-cast streams summed per sender over every slot
    (``segment_sum``), as the JAX VJP adds them."""
    de, dpre1, dpre2, du_r, dv_r, dwe, db0, dw2, db2 = fused_edge2_bwd_reference(
        proj_u, proj_v, e, w_e, b0, w2, b2, receivers, senders, aux, n_graphs, tile,
        z_upd, dz_upd, dr, dm)
    Np = proj_u.shape[0]
    du = du_r + segment_sum(dpre2.float(), senders, Np)
    dv = dv_r + segment_sum(dpre1.float(), senders, Np)
    return du, dv, de, dwe, db0, dw2, db2


def fused_edge_step2_backward(
    proj_u: torch.Tensor, proj_v: torch.Tensor, e: torch.Tensor, w_e: torch.Tensor,
    b0: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor, receivers: torch.Tensor,
    senders: torch.Tensor, aux: PairAux, n_graphs: int, tile: int,
    z_upd: torch.Tensor,  # (Ep, L) the forward's output, stream dtype
    dz_upd: torch.Tensor,  # (Ep, L) cotangents, stream dtype
    dr: torch.Tensor,  # (Np, L) fp32
    dm: torch.Tensor,  # (8, L) fp32
) -> tuple[torch.Tensor, ...]:
    """The fused2 edge step's VJP: (du, dv, de, dWe, db0, dW2, db2), de in
    the stream dtype, the rest fp32. The backward kernel (or its plain
    version, for CPU tensors) gives the receiver sums du_r, dv_r and the
    dpre1, dpre2 streams; one pair segment sum over the batch's sender view
    (``csr_segment_sum_pair``, kernel or plain version alike) adds them per
    sender: du = du_r + S(dpre2), dv = dv_r + S(dpre1). Without the sender
    view it raises."""
    if len(aux) < 6 or aux[3] is None:
        raise ValueError("fused_edge_step2_backward needs the batch's sender view "
                         "(pack_batch(sender_view=True))")
    de, dpre1, dpre2, du_r, dv_r, dwe, db0, dw2, db2 = fused_edge2_bwd(
        proj_u, proj_v, e, w_e, b0, w2, b2, receivers, senders, aux, n_graphs, tile,
        z_upd, dz_upd, dr, dm)
    snd_perm, snd_sorted, snd_block_tile = aux[3:6]
    s_u, s_v = csr_segment_sum_pair(dpre2, dpre1, snd_sorted, snd_block_tile, du_r.shape[0],
                                    tile, perm=snd_perm)
    return du_r + s_u, dv_r + s_v, de, dwe, db0, dw2, db2


def _fused_edge_step2_forward(proj_u, proj_v, e, w_e, b0, w2, b2, receivers, senders, aux,
                              n_graphs, tile):
    edge_gid, block_tile, block_snd_tile = aux[:3]
    args = (proj_u, proj_v, e, w_e, b0, w2, b2, receivers, senders)
    if cuda_build.device_kind("fused_edge_step2", *args, edge_gid, block_tile,
                              block_snd_tile) == "cuda":
        return _fused_edge_step2_cuda(*args, edge_gid, block_tile, block_snd_tile, n_graphs,
                                      tile)
    return fused_edge_step2_reference(*args, aux, n_graphs, tile)


class _FusedEdgeStep2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, proj_u, proj_v, e, w_e, b0, w2, b2, receivers, senders, n_graphs, tile,
                *aux):
        z_upd, r, m = _fused_edge_step2_forward(proj_u, proj_v, e, w_e, b0, w2, b2,
                                                receivers, senders, aux, n_graphs, tile)
        # what the JAX VJP saves (`_step2_fwd`): the inputs and z_upd
        ctx.save_for_backward(proj_u, proj_v, e, w_e, b0, w2, b2, receivers, senders, z_upd,
                              *aux)
        ctx.n_graphs, ctx.tile = n_graphs, tile
        return z_upd, r, m

    @staticmethod
    def backward(ctx, dz_upd, dr, dm):
        saved = ctx.saved_tensors
        inputs, (receivers, senders, z_upd), aux = saved[:7], saved[7:10], saved[10:]
        grads = fused_edge_step2_backward(
            *inputs, receivers, senders, aux, ctx.n_graphs, ctx.tile, z_upd,
            dz_upd.contiguous(), dr.contiguous(), dm.contiguous())
        return (*(gr.to(t.dtype) for gr, t in zip(grads, inputs)),) + (None,) * (4 + len(aux))


def fused_edge_step2(
    proj_u: torch.Tensor,  # (Np, L) x·Wu, stream dtype
    proj_v: torch.Tensor,  # (Np, L) x·Wv, stream dtype
    e: torch.Tensor,  # (Ep, L) edge latents in the pair-blocked order
    w_e: torch.Tensor,  # (L, L)
    b0: torch.Tensor,  # (L,)
    w2: torch.Tensor,  # (L, L)
    b2: torch.Tensor,  # (L,)
    receivers: torch.Tensor,  # (Ep,) i32
    senders: torch.Tensor,  # (Ep,) i32
    aux: PairAux,  # (edge_gid, block_tile, block_snd_tile, perm, sorted,
    #               snd_block_tile): the sender view, in any slot order within
    #               a tile (the Processor passes its run order); it may be
    #               None when no gradient is taken
    n_graphs: int,
    tile: int,  # node tile of the layout (GraphBatch.tile)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The pair-blocked edge step (``scatter_impl="fused2"``): (z_upd, R, M)
    as ``fused_edge_step`` returns them, with both endpoint gathers and the
    e-projection inside. For every slot with receiver r and sender s, the
    messages evaluate the edge MLP on u[r] + v[s] and the edge update on
    v[r] + u[s] (u = proj_u, v = proj_v); an endpoint outside its block's
    receiver or sender tile reads zero, as the TPU kernel's one-hot
    contractions do (the layout never makes one). Differentiable in proj_u,
    proj_v, e and the weights. CUDA tensors go to the kernels
    (``cuda_build.launches`` counts them under ``fused_edge2_fwd``,
    ``fused_edge2_bwd`` and ``segment_sum_csr_pair``), CPU tensors to the
    plain versions; anything else raises. Without the sender view it is
    forward-only and raises if an input needs a gradient."""
    view = tuple(aux[3:6])
    if not view or view[0] is None:
        view = ()
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (proj_u, proj_v, e, w_e, b0, w2, b2)):
            raise ValueError(
                "fused_edge_step2 needs the batch's sender view for its backward "
                "(pack_batch(sender_view=True))")
    return _FusedEdgeStep2.apply(proj_u, proj_v, e, w_e, b0, w2, b2, receivers, senders,
                                 n_graphs, tile, *aux[:3], *view)
