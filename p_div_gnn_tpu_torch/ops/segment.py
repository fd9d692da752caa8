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


def runs_are_consecutive(segment_ids: torch.Tensor, num_segments: int) -> bool:
    """Whether the slots of each segment in [0, num_segments) are
    consecutive: one run per segment. Slots with another id (the layouts'
    -1 padding) belong to no segment and end a run."""
    seg = torch.where((segment_ids >= 0) & (segment_ids < num_segments),
                      segment_ids.long(), -1)
    start = seg >= 0
    start[1:] &= seg[1:] != seg[:-1]
    return bool((torch.bincount(seg[start], minlength=num_segments) <= 1).all())


def require_consecutive_runs(segment_ids: torch.Tensor, num_segments: int, who: str) -> None:
    """Raise unless ``runs_are_consecutive``: the kernels that sum a segment
    as one run and write it once need it. The answer is kept on the tensor
    (with its version counter), so a layout reused across calls, such as a
    batch's over its steps, is checked once: the check synchronizes with
    the device."""
    key = (segment_ids._version, num_segments)
    if getattr(segment_ids, "_pdg_runs_checked", None) == key:
        return
    if not runs_are_consecutive(segment_ids, num_segments):
        raise ValueError(
            f"{who}: a segment's slots are not consecutive; its kernel sums each "
            "segment as one run (the receiver-major layout, or the sender view in "
            "run order: GraphBatch.snd_run_perm / snd_run_sorted)"
        )
    segment_ids._pdg_runs_checked = key
