"""Fused edge-step v3 forward: the raw-x message-passing step of the fused3
path — the counterpart of ``p_div_gnn_tpu/ops/fused_edge3.py``
(``fused_edge_step3``, whose forward is the Pallas kernel ``_step3_kernel``).

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

``fused_edge_step3`` runs the hand-written CUDA kernel
(``csrc/fused_edge3_fwd.cu``) for CUDA tensors and the plain PyTorch version
``fused_edge_step3_reference`` for CPU tensors; there is no fallback from one
to the other. In bf16 stream mode both round where the JAX package rounds:
bf16 operands with fp32 accumulation, ``relu(pre)`` rounded to bf16 before
``·W2``, R summing the bf16-rounded z_msg and M the fp32 z.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from p_div_gnn_tpu_torch.ops.cuda_build import CudaLibrary, load_cuda_library
from p_div_gnn_tpu_torch.ops.segment import segment_sum

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
        [ctypes.c_int] + [ctypes.c_void_p] * 16 + [ctypes.c_int64] * 6
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    built.lib.pdg_cuda_error_string.argtypes = [ctypes.c_int]
    built.lib.pdg_cuda_error_string.restype = ctypes.c_char_p
    return built


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
    _check(L % 4 == 0 and 4 <= L <= 1024, f"L={L} must be a multiple of 4 in [4, 1024]")
    _check(Np * L < 2**31 and Ep * L < 2**31, "arrays too large")

    dev = x.device
    z_upd = torch.empty((Ep, L), dtype=sd, device=dev)
    r = torch.empty((Np, L), dtype=torch.float32, device=dev)
    mpart = torch.empty((Np // tile, 4, L), dtype=torch.float64, device=dev)
    m = torch.empty((8, L), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = built.lib.pdg_fused_edge3_fwd(
            int(sd == torch.bfloat16),
            *(t.data_ptr() for t in (x, g_x, e, receivers, edge_gid, block_tile,
                                     w_u, w_v, w_e, w2, b0, b2, z_upd, r, mpart, m)),
            Np, Ep, L, tile, n_blocks, int(n_graphs), stream,
        )
    if err != 0:
        msg = built.lib.pdg_cuda_error_string(err).decode()
        raise RuntimeError(f"fused_edge3_fwd launch failed: {msg} ({err})")
    fused_edge_step3.launches += 1
    return z_upd, r, m


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
    """The fused3 edge step: (z_upd, R, M). CUDA tensors go to the kernel
    (``fused_edge_step3.launches`` counts its launches), CPU tensors to the
    plain version; anything else raises."""
    edge_gid, block_tile = aux
    args = (x, g_x, e, w_u, w_v, w_e, b0, w2, b2, receivers)
    kinds = {t.device.type for t in args + (edge_gid, block_tile)}
    if kinds == {"cuda"}:
        return _fused_edge_step3_cuda(*args, edge_gid, block_tile, n_graphs, tile)
    if kinds == {"cpu"}:
        return fused_edge_step3_reference(*args, edge_gid, n_graphs)
    raise ValueError(f"fused_edge_step3 runs on cuda or cpu tensors, got {sorted(kinds)}")


fused_edge_step3.launches = 0  # type: ignore[attr-defined]
