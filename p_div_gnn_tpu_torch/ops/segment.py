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

from p_div_gnn_tpu_torch.utils.profiling import count


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
    the device, and counts one ``host_sync.require_consecutive_runs``."""
    key = (segment_ids._version, num_segments)
    if getattr(segment_ids, "_pdg_runs_checked", None) == key:
        return
    count("host_sync.require_consecutive_runs")
    if not runs_are_consecutive(segment_ids, num_segments):
        raise ValueError(
            f"{who}: a segment's slots are not consecutive; its kernel sums each "
            "segment as one run (the receiver-major layout, or the sender view in "
            "run order: GraphBatch.snd_run_perm / snd_run_sorted)"
        )
    segment_ids._pdg_runs_checked = key


def live_slots(edge_gid: torch.Tensor, n_graphs: int, block: int) -> int:
    """The edge slots up to the last real one (``edge_gid < n_graphs``),
    rounded up to whole blocks (at least one). The fused edge steps mask
    the messages, updates and cotangents of padding slots to zero, so the
    slots after these need not run: a loader's bucketed batch gives its
    spare capacity to its last node tile, as one receiver run of padding
    (119,040 slots of 393,216 in a flagship batch), which the kernels'
    run-aligned parts would hand to one CTA. Kept on the tensor with its
    version counter, as the run check is: reading it synchronizes, and
    counts one ``host_sync.live_slots``."""
    key = (edge_gid._version, n_graphs, block)
    cached = getattr(edge_gid, "_pdg_live_slots", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    count("host_sync.live_slots")
    n = edge_gid.shape[0]
    slot = torch.arange(n, device=edge_gid.device)
    end = int(torch.where(edge_gid < n_graphs, slot, -1).max()) + 1 if n else 0
    live = min(max(-(-end // block), 1) * block, n)
    edge_gid._pdg_live_slots = (key, live)
    return live


def slot_outputs(n: int, count: int, Ep: int, L: int, dtype: torch.dtype,
                 device: torch.device) -> list[torch.Tensor]:
    """``count`` (Ep, L) per-slot outputs of a kernel that writes only the
    first ``n`` slots (``live_slots``): the slots after them are zero, as
    the plain versions leave padding."""
    outs = [torch.empty((Ep, L), dtype=dtype, device=device) for _ in range(count)]
    for t in outs:
        t[n:].zero_()
    return outs
