"""Block-CSR segment sums — the counterpart of
``p_div_gnn_tpu/ops/scatter_pallas.py``'s ``pallas_segment_sum`` (whose
forward is the Pallas kernel ``_kernel``) and ``pallas_segment_sum_pair``
(the Pallas kernel ``_kernel_pair``).

``out[n] = Σ rows[s]`` over the slots s with ``receivers[s] == n``,
accumulated in fp64 and returned as (num_nodes, L) fp32. Slots with
receiver −1 add nothing. With ``perm``, slot s reads ``rows[perm[s]]``: the
sender gather's backward (``ops/gather.py``) permutes its cotangent into
the sender-major view this way.

``csr_segment_sum`` runs the hand-written CUDA kernel
(``csrc/segment_sum_csr.cu``, a streaming segmented reduction) for CUDA
tensors and the plain PyTorch version ``csr_segment_sum_reference`` for CPU
tensors; there is no fallback from one to the other. The kernel sums each
run of consecutive slots with one receiver once, so the slots of a receiver
must be consecutive: the receiver-major layout is sorted so, and the sender
gathers read the sender view in its derived order
(``GraphBatch.snd_run_perm`` / ``snd_run_sorted``). On a CUDA tensor whose
receivers are not so, the wrapper raises (``require_consecutive_runs``,
checked once per layout tensor); the plain version takes any order, as the
JAX function does. ``block_tile`` and ``tile`` name the layout's blocks, as
the JAX function takes them; neither the kernel nor the plain version reads
them. Its backward is a plain gather, as in the JAX package.

``csr_segment_sum_pair`` sums two streams (fp32 or bf16, read as stored)
over one layout with the same kernel design, both streams in one launch
(same source), or ``csr_segment_sum_pair_reference`` on the CPU, which casts
the rows to fp32 inside as the JAX function does; it needs each receiver's
slots consecutive on CUDA tensors, as the segment sum does, and both of its
callers (the pair sender gather's backward and the fused2 backward's
sender-side sums) pass the sender view in run order. It has no backward of
its own. Both kernels take any L: the wrapper zero-pads the columns to a
multiple of 4 (the kernels' four-column loads), which is exact for a sum,
and slices the sums back.
"""

from __future__ import annotations

import torch

from p_div_gnn_tpu_torch.ops import cuda_build
from p_div_gnn_tpu_torch.ops.segment import require_consecutive_runs, segment_sum
from p_div_gnn_tpu_torch.ops.widths import pad_width, unpad

ROW_DTYPES = (torch.float32, torch.bfloat16)


def _cols4(L: int) -> int:
    """L rounded up to the kernels' four-column loads."""
    return -(-L // 4) * 4


def csr_segment_sum_reference(
    rows: torch.Tensor, receivers: torch.Tensor, num_nodes: int,
    perm: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch version: (permute,) mask the −1 slots, ``segment_sum``
    (fp64 accumulation, rounded once to fp32)."""
    if perm is not None:
        rows = rows.index_select(0, perm)
    valid = receivers >= 0
    data = torch.where(valid[:, None], rows.float(), 0.0)
    return segment_sum(data, torch.where(valid, receivers, 0), num_nodes)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"csr_segment_sum: {msg}")


def _csr_segment_sum_cuda(
    rows: torch.Tensor, receivers: torch.Tensor, num_nodes: int, perm: torch.Tensor | None,
) -> torch.Tensor:
    built = cuda_build.library("segment_sum_csr")
    n_src, L = rows.shape
    n_slots = receivers.shape[0]
    ints = (receivers,) + (() if perm is None else (perm,))
    _check(rows.dtype in ROW_DTYPES, f"row dtype {rows.dtype} is not float32 or bfloat16")
    _check(all(t.dtype == torch.int32 for t in ints), "index arrays must be int32")
    _check(len({t.device for t in (rows,) + ints}) == 1, "tensors on several devices")
    _check(all(t.is_contiguous() for t in (rows,) + ints), "tensors must be contiguous")
    _check(receivers.dim() == 1 and n_slots > 0 and (perm is None or perm.shape == receivers.shape),
           "receivers (and perm) must be (Ep2,)")
    _check(perm is not None or n_src == n_slots, "rows must be (Ep2, L) without perm")
    _check(L >= 1, f"L={L} is not a width")
    _check(n_src * L < 2**31 and num_nodes * L < 2**31 and 2 * n_slots * L < 2**31,
           "arrays too large")
    require_consecutive_runs(receivers, num_nodes, "csr_segment_sum")
    if _cols4(L) != L:
        return unpad(_csr_segment_sum_cuda(pad_width(rows, _cols4(L)), receivers, num_nodes,
                                           perm), L)

    dev = rows.device
    n_chunks = -(-n_slots // built.lib.pdg_segment_sum_csr_chunk_slots())
    pieces = torch.empty((n_chunks, 2, L), dtype=torch.float64, device=dev)
    kind = torch.empty((n_chunks,), dtype=torch.int32, device=dev)
    out = torch.empty((num_nodes, L), dtype=torch.float32, device=dev)
    cuda_build.launch("segment_sum_csr", "pdg_segment_sum_csr", int(rows.dtype == torch.bfloat16),
                      rows, perm, receivers, pieces, kind, out, n_src, n_slots, L, num_nodes)
    return out


def _segment_sum_dispatch(rows, receivers, block_tile, num_nodes, tile, perm):
    tensors = (rows, receivers, block_tile) + (() if perm is None else (perm,))
    if cuda_build.device_kind("csr_segment_sum", *tensors) == "cuda":
        return _csr_segment_sum_cuda(rows, receivers, num_nodes, perm)
    return csr_segment_sum_reference(rows, receivers, num_nodes, perm)


class _CsrSegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, receivers, block_tile, num_nodes, tile, perm):
        ctx.save_for_backward(receivers, perm)
        ctx.n_src = rows.shape[0]
        ctx.row_dtype = rows.dtype
        return _segment_sum_dispatch(rows, receivers, block_tile, num_nodes, tile, perm)

    @staticmethod
    def backward(ctx, g):
        # transpose of a scatter-add is a gather; −1 slots get 0
        receivers, perm = ctx.saved_tensors
        valid = (receivers >= 0)[:, None]
        d = torch.where(valid, g.index_select(0, receivers.clamp(min=0)), 0.0)
        if perm is not None:
            # undo the permutation; each source row appears once among the
            # valid slots, padding slots add a zero
            d = torch.zeros((ctx.n_src, g.shape[1]), dtype=g.dtype,
                            device=g.device).index_add_(0, perm, d)
        return d.to(ctx.row_dtype), None, None, None, None, None


def csr_segment_sum(
    rows: torch.Tensor,  # (Ep2, L) f32 or bf16; (n_src, L) with perm
    receivers: torch.Tensor,  # (Ep2,) i32 node id per slot, −1 for padding
    block_tile: torch.Tensor,  # (Ep2 / block,) i32 node tile per block; not read
    num_nodes: int,
    tile: int,  # node tile of the layout (GraphBatch.tile); not read
    perm: torch.Tensor | None = None,  # (Ep2,) i32 source row of each slot
) -> torch.Tensor:
    """(num_nodes, L) fp32 segment sum over the block-CSR layout. CUDA
    tensors go to the kernel (``cuda_build.launches["segment_sum_csr"]``
    counts its launches), which needs each receiver's slots consecutive
    and raises otherwise; CPU tensors go to the plain version, which takes
    any order; anything else raises. ``block_tile`` and ``tile`` are taken as the JAX
    function takes them and are not read."""
    return _CsrSegmentSum.apply(rows, receivers, block_tile, num_nodes, tile, perm)


def csr_segment_sum_pair_reference(
    a: torch.Tensor, b: torch.Tensor, receivers: torch.Tensor, num_nodes: int,
    perm: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the pair sum: two ``csr_segment_sum_reference``."""
    return (csr_segment_sum_reference(a, receivers, num_nodes, perm),
            csr_segment_sum_reference(b, receivers, num_nodes, perm))


def _csr_segment_sum_pair_cuda(
    a: torch.Tensor, b: torch.Tensor, receivers: torch.Tensor, block_tile: torch.Tensor,
    num_nodes: int, tile: int, perm: torch.Tensor | None,
) -> tuple[torch.Tensor, torch.Tensor]:
    built = cuda_build.library("segment_sum_csr")
    n_src, L = a.shape
    n_slots = receivers.shape[0]
    ints = (receivers, block_tile) + (() if perm is None else (perm,))
    _check(a.dtype == b.dtype and a.dtype in ROW_DTYPES,
           "the pair sum takes two float32 or two bfloat16 streams")
    _check(a.shape == b.shape, "the two streams must have one shape")
    _check(all(t.dtype == torch.int32 for t in ints), "index arrays must be int32")
    _check(len({t.device for t in (a, b) + ints}) == 1, "tensors on several devices")
    _check(all(t.is_contiguous() for t in (a, b) + ints), "tensors must be contiguous")
    _check(receivers.dim() == 1 and n_slots > 0 and (perm is None or perm.shape == receivers.shape),
           "receivers (and perm) must be (Ep2,)")
    _check(perm is not None or n_src == n_slots, "rows must be (Ep2, L) without perm")
    n_blocks = block_tile.shape[0]
    _check(block_tile.dim() == 1 and n_blocks > 0 and n_slots % n_blocks == 0,
           "slots must split into whole blocks")
    _check(tile > 0 and num_nodes % tile == 0,
           f"num_nodes={num_nodes} is not a multiple of tile={tile}")
    _check(L >= 1, f"L={L} is not a width")
    _check(n_src * L < 2**31 and 2 * num_nodes * L < 2**31 and 4 * n_slots * L < 2**31,
           "arrays too large")
    require_consecutive_runs(receivers, num_nodes, "csr_segment_sum_pair")
    if _cols4(L) != L:
        Lq = _cols4(L)
        out = _csr_segment_sum_pair_cuda(pad_width(a, Lq), pad_width(b, Lq), receivers,
                                         block_tile, num_nodes, tile, perm)
        return unpad(out[0], L), unpad(out[1], L)

    dev = a.device
    n_chunks = -(-n_slots // built.lib.pdg_segment_sum_csr_chunk_slots())
    pieces = torch.empty((2, n_chunks, 2, L), dtype=torch.float64, device=dev)
    kind = torch.empty((n_chunks,), dtype=torch.int32, device=dev)
    out = torch.empty((2, num_nodes, L), dtype=torch.float32, device=dev)
    cuda_build.launch("segment_sum_csr_pair", "pdg_segment_sum_csr_pair",
                      int(a.dtype == torch.bfloat16), a, b, perm, receivers, pieces, kind, out,
                      n_src, n_slots, L, num_nodes)
    return out[0], out[1]


def csr_segment_sum_pair(
    a: torch.Tensor,  # (Ep2, L) f32 or bf16; (n_src, L) with perm
    b: torch.Tensor,  # the second stream, shaped and typed as a
    receivers: torch.Tensor,  # (Ep2,) i32 node id per slot, −1 for padding
    block_tile: torch.Tensor,  # (Ep2 / block,) i32 node tile per block, sorted
    num_nodes: int,
    tile: int,  # node tile of the layout (GraphBatch.tile)
    perm: torch.Tensor | None = None,  # (Ep2,) i32 source row of each slot
) -> tuple[torch.Tensor, torch.Tensor]:
    """Two (num_nodes, L) fp32 segment sums of two streams over one
    block-CSR layout, in one pass, the rows read as stored and summed in
    fp64. CUDA tensors go to the kernel
    (``cuda_build.launches["segment_sum_csr_pair"]`` counts its launches),
    which needs each receiver's slots consecutive and raises otherwise; CPU
    tensors go to the plain version, which takes any order; anything else
    raises. It has no backward: it raises where a
    gradient would be needed."""
    tensors = (a, b, receivers, block_tile) + (() if perm is None else (perm,))
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        raise ValueError("csr_segment_sum_pair has no backward; call it where no "
                         "gradient is taken (a backward, or torch.no_grad)")
    if cuda_build.device_kind("csr_segment_sum_pair", *tensors) == "cuda":
        return _csr_segment_sum_pair_cuda(a, b, receivers, block_tile, num_nodes, tile, perm)
    return csr_segment_sum_pair_reference(a, b, receivers, num_nodes, perm)
