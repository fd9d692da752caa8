"""Mask-aware graph-mode LayerNorm — the counterpart of
``p_div_gnn_tpu/ops/layernorm.py``.

PyG's ``LayerNorm`` in graph mode with ``batch=None`` (the reference,
`models.py:27-30`) normalizes with the mean and the biased std of the whole
(rows × channels) tensor, adds eps to the std (not the variance), then
applies a per-channel affine. Padding rows are excluded from the statistics
and zeroed in the output.
"""

from __future__ import annotations

import torch


def masked_graph_layernorm(
    x: torch.Tensor,
    mask: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Normalize x (R, C) by masked whole-tensor mean/std, then affine;
    ``mask`` (R,) is 1 (or True) for real rows."""
    m = mask.to(x.dtype)[:, None]
    count = torch.clamp(m.sum() * x.shape[-1], min=1.0)
    mean = (x * m).sum() / count
    centered = (x - mean) * m
    std = torch.sqrt((centered * centered).sum() / count)
    out = (x - mean) / (std + eps)
    return (out * weight + bias) * m
