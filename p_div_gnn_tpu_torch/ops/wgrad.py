"""The weight-grad pass of the three one-pass edge-step backwards (#2
``fused_edge3_bwd``, #6 ``fused_edge_bwd``, #8 ``fused_edge2_bwd``):
``csrc/bwd_common.cuh``'s ``bwd_wgrad_kernel_ws`` sums W[m] = Σ_p Σ_i
A_p[i]ᵀ B_p[i] over the (A, B) stream pairs of each weight grad in 32-row
fp32 partials added in fp64.

``wgrad_pass`` runs the pass alone (the card tests hold it against a plain
fp64 sum); on CPU tensors it is that plain sum.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from p_div_gnn_tpu_torch.ops import cuda_build

WGRAD_WIDTHS = (64, 128, 256)
MAX_STREAMS = 10  # csrc/bwd_common.cuh MAX_STREAMS
MAX_PAIRS = 2  # csrc/bwd_common.cuh MAX_PAIRS


def wgrad_pass_reference(
    streams: Sequence[torch.Tensor], at_idx: Sequence[bool], idx: torch.Tensor | None,
    pairs: Sequence[Sequence[tuple[int, int]]], n_rows: int,
) -> torch.Tensor:
    """Plain version: (n_mats, L, L) fp32, each Σ AᵀB over the first n_rows
    rows in fp64, rounded once; an indexed stream's row i is row idx[i],
    zero outside the stream."""
    rows = []
    for s, k in zip(streams, at_idx):
        if k:
            i = idx[:n_rows].long()
            ok = (i >= 0) & (i < s.shape[0])
            rows.append(torch.where(ok[:, None], s.double()[i.clamp(0, s.shape[0] - 1)], 0.0))
        else:
            rows.append(s[:n_rows].double())
    return torch.stack([sum(rows[a].t() @ rows[b] for a, b in mat) for mat in pairs]).float()


def wgrad_pass(
    streams: Sequence[torch.Tensor], at_idx: Sequence[bool], idx: torch.Tensor | None,
    pairs: Sequence[Sequence[tuple[int, int]]], n_rows: int | None = None,
) -> torch.Tensor:
    """The weight-grad pass alone over n_rows rows: (n_mats, L, L) fp32 with
    W[m] = Σ over weight grad m's (a, b) stream pairs of Σ_i A[i]ᵀB[i].
    ``streams`` are (·, L) in one stream dtype (fp32 or bf16), L 64, 128 or
    256; an ``at_idx`` stream's row i is row idx[i] (int32), missing (zero)
    outside the stream. CUDA tensors go to the kernels of
    ``csrc/fused_edge3_bwd.cu``, CPU tensors to the plain version."""
    if n_rows is None:
        n_rows = idx.shape[0] if idx is not None else streams[0].shape[0]
    if streams[0].device.type == "cpu":
        return wgrad_pass_reference(streams, at_idx, idx, pairs, n_rows)
    return _wgrad_pass_cuda(streams, at_idx, idx, pairs, n_rows)


def _wgrad_pass_cuda(streams, at_idx, idx, pairs, n_rows: int) -> torch.Tensor:
    built = cuda_build.library("fused_edge3_bwd")
    sd, L, dev = streams[0].dtype, streams[0].shape[1], streams[0].device
    if not (sd in (torch.float32, torch.bfloat16) and L in WGRAD_WIDTHS
            and all(s.dtype == sd and s.dim() == 2 and s.shape[1] == L and s.is_contiguous()
                    and s.device == dev for s in streams)
            and 0 < len(streams) <= MAX_STREAMS and 0 < len(pairs) <= 4
            and all(0 < len(m) <= MAX_PAIRS for m in pairs)):
        raise ValueError("wgrad_pass: streams must share a dtype (fp32, bf16), a device and a "
                         "width (64, 128, 256); at most 10 streams, 4 weight grads of 1-2 pairs")
    n_idx = {s.shape[0] for s, k in zip(streams, at_idx) if k}
    if n_idx and (idx is None or idx.dtype != torch.int32 or idx.shape[0] < n_rows
                  or len(n_idx) > 1):
        raise ValueError("wgrad_pass: indexed streams need int32 indices for every row and "
                         "one length")
    n_mats = len(pairs)
    n_chunks = built.lib.pdg_wgrad_chunks(n_rows, n_mats)
    wpart = torch.empty((n_chunks, n_mats, L, L), dtype=torch.float64, device=dev)
    wb = torch.empty((n_mats * L + 2, L), dtype=torch.float32, device=dev)
    src = (ctypes.c_void_p * len(streams))(*(s.data_ptr() for s in streams))
    kind = (ctypes.c_int * len(streams))(*(int(k) for k in at_idx))
    n_pairs = (ctypes.c_int * n_mats)(*(len(m) for m in pairs))
    pa = (ctypes.c_int * (2 * n_mats))(*(m[p][0] if p < len(m) else 0 for m in pairs
                                         for p in range(2)))
    pb = (ctypes.c_int * (2 * n_mats))(*(m[p][1] if p < len(m) else 0 for m in pairs
                                         for p in range(2)))
    cuda_build.launch("fused_edge3_bwd_wgrad", "pdg_fused_edge3_bwd_wgrad",
                      int(sd == torch.bfloat16), src, kind, len(streams), idx,
                      max(n_idx, default=0), n_mats, n_pairs, pa, pb, wpart, wb, n_rows, L,
                      n_chunks, device=dev)
    return wb[:n_mats * L].view(n_mats, L, L)
