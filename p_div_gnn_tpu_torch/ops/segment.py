"""Segment sum over receiver ids — the counterpart of
``p_div_gnn_tpu/ops/segment.py``'s ``jax.ops.segment_sum``.

``index_add_`` adds with atomics on the card, in an order that changes from
run to run. The sums are taken in fp64 and rounded once to the data's dtype,
so the result is the correctly rounded sum and the same in every run: the
trained model amplifies one-ulp changes in its aggregated messages to ~1e-5
in its standardized output at the flagship size, which is the size of the
tolerance its fused path is held to against this plain path.
"""

from __future__ import annotations

import torch


def segment_sum(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """``out[s] = Σ data[i]`` over ``segment_ids[i] == s``, accumulated in
    fp64 and returned in ``data``'s dtype."""
    out = torch.zeros(
        (num_segments,) + tuple(data.shape[1:]), dtype=torch.float64,
        device=data.device,
    )
    out.index_add_(0, segment_ids, data.double())
    return out.to(data.dtype)
