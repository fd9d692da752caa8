"""Mask-aware graph-mode LayerNorm — the counterpart of
``p_div_gnn_tpu/ops/layernorm.py``.

PyG's ``LayerNorm`` in graph mode with ``batch=None`` (the reference,
`models.py:27-30`) normalizes with the mean and the biased std of the whole
(rows × channels) tensor, adds eps to the std (not the variance), then
applies a per-channel affine. Padding rows are excluded from the statistics
and zeroed in the output. Under data-parallel or edge-partitioned execution
(``group`` set) the count, the total and the centred square sum are summed
over the group's ranks in fp64 (``psum64``), so a shard normalizes with the
whole batch's statistics (JAX: ``axis_name``).
"""

from __future__ import annotations

import torch

from p_div_gnn_tpu_torch.parallel.collectives import Group, psum64


def masked_graph_layernorm(
    x: torch.Tensor,
    mask: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    eps: float = 1e-5,
    group: Group | None = None,
) -> torch.Tensor:
    """Normalize x (R, C) by masked whole-tensor mean/std, then affine;
    ``mask`` (R,) is 1 (or True) for real rows."""
    m = mask.to(x.dtype)[:, None]
    count, total = psum64(torch.stack([m.sum() * x.shape[-1], (x * m).sum()]), group)
    count = torch.clamp(count, min=1.0)
    mean = total / count
    centered = (x - mean) * m
    std = torch.sqrt(psum64((centered * centered).sum(), group) / count)
    out = (x - mean) / (std + eps)
    return (out * weight + bias) * m
