"""Lazy graph-LN helpers of the fused edge step — the counterparts of
``moments_from_partials`` and ``lazy_layernorm_affine`` in
``p_div_gnn_tpu/ops/fused_edge.py:547-597``.

The fused kernel returns per-lane partial sums M of the pre-masked z; the
graph-LN that follows in the reference (`models.py:199,207`) is then folded
into its consumers as a per-lane affine, ``LN(z) = z·alpha + beta`` on real
rows.
"""

from __future__ import annotations

import torch


def moments_from_partials(
    m_sum: torch.Tensor, m_sumsq: torch.Tensor, edge_mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Whole-tensor mean/std from per-lane partial sums (padding rows
    contribute exactly 0)."""
    L = m_sum.shape[-1]
    count = torch.clamp(edge_mask.to(m_sum.dtype).sum() * L, min=1.0)
    mean = m_sum.sum() / count
    # One-pass variance E[z²] − mean² can cancel to ≤ 0 in fp32; the 1e-12
    # floor is far below any healthy variance and keeps sqrt finite.
    var = torch.clamp(m_sumsq.sum() / count - mean * mean, min=1e-12)
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
