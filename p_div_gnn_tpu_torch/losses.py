"""Per-graph NMSE and the divergence penalty — the counterpart of
``p_div_gnn_tpu/losses.py`` (``per_graph_nmse``, ``divergence_field``,
``per_graph_divergence``, ``batch_loss``, ``partitioned_batch_loss``).

Every per-graph quantity is a segment reduction keyed by graph id over the
padded batch (padding nodes carry graph id ``n_graphs`` and fall into an
extra segment that is dropped). The divergence operator is applied through
its gather-only ELL views when the batch has them (forward: the row view;
backward: the transpose view, an ``autograd.Function``), else through the
padded COO.

Under data parallelism (``batch_loss(..., group=)``) the per-graph sums and
the real-graph counts are summed over the ranks, so every rank holds the
whole batch's loss; under edge partitioning (``partitioned_batch_loss``) the
same graphs are split across the ranks, so every per-graph segment sum is.
"""

from __future__ import annotations

import torch

from p_div_gnn_tpu_torch.graphs.container import GraphBatch
from p_div_gnn_tpu_torch.ops.segment import segment_sum
from p_div_gnn_tpu_torch.parallel.collectives import Group, psum


class _DivEllApply(torch.autograd.Function):
    """(Np, 3) stress → (Np, 2) div through the row ELL view; the VJP
    contracts the transpose ELL view, so neither direction scatters."""

    @staticmethod
    def forward(ctx, stress, div_src, div_val, div_isy, divT_row, divT_val, divT_isy):
        ctx.save_for_backward(divT_row, divT_val, divT_isy)
        g = stress[div_src]  # (Np, W, 3)
        isy = div_isy.to(stress.dtype)
        v0 = g[..., 0] * (1 - isy) + g[..., 2] * isy
        v1 = g[..., 2] * (1 - isy) + g[..., 1] * isy
        return torch.stack([(div_val * v0).sum(1), (div_val * v1).sum(1)], dim=-1)

    @staticmethod
    def backward(ctx, ct):
        divT_row, divT_val, divT_isy = ctx.saved_tensors
        h = ct[divT_row]  # (Np, Wt, 2)
        isy = divT_isy.to(ct.dtype)
        w0 = divT_val * h[..., 0]
        w1 = divT_val * h[..., 1]
        # entry (r, s, isy): isy=0 → dS[s,0] += val·ct[r,0], dS[s,2] += val·ct[r,1]
        #                    isy=1 → dS[s,2] += val·ct[r,0], dS[s,1] += val·ct[r,1]
        ds0 = (w0 * (1 - isy)).sum(1)
        ds1 = (w1 * isy).sum(1)
        ds2 = (w0 * isy + w1 * (1 - isy)).sum(1)
        return torch.stack([ds0, ds1, ds2], dim=-1), None, None, None, None, None, None


def per_graph_nmse(
    batch: GraphBatch, prediction: torch.Tensor, ground_truth: torch.Tensor
) -> torch.Tensor:
    """Per-graph normalized MSE, shape (G,): for each graph and stress
    component ``Σ_n (gt - pred)² / Σ_n (gt - mean_n(gt))²``, then the mean
    over the 3 components."""
    G = batch.n_graphs
    gid = batch.node_gid.long()
    mask = batch.node_mask.to(prediction.dtype)[:, None]

    gt = ground_truth * mask
    pred = prediction * mask
    count = segment_sum(mask, gid, G + 1)  # (G+1, 1)
    sum_gt = segment_sum(gt, gid, G + 1)  # (G+1, 3)
    mean_gt = sum_gt / torch.clamp(count, min=1.0)

    num = segment_sum((gt - pred) ** 2 * mask, gid, G + 1)
    den = segment_sum((gt - mean_gt[gid]) ** 2 * mask, gid, G + 1)
    ratio = num / torch.where(den == 0, torch.ones_like(den), den)
    return ratio.mean(-1)[:G]


def divergence_field(
    batch: GraphBatch, stress: torch.Tensor, zero_internal_boundary: bool = True
) -> torch.Tensor:
    """Nodal divergence vectors (Np, 2) of a (Np, 3) [xx, yy, xy] field.
    Component 0 contracts (σxx, σxy) and component 1 (σxy, σyy) over the x
    and y dofs. Boundary rows are zeroed: both boundary types for the
    training penalty, only the external boundary for analysis fields."""
    Np = stress.shape[0]
    if batch.div_src is not None:
        div = _DivEllApply.apply(
            stress, batch.div_src.long(), batch.div_val, batch.div_isy,
            batch.divT_row.long(), batch.divT_val, batch.divT_isy,
        )
    else:
        # COO fallback (pack_batch(div_ell=False))
        is_y = batch.div_col_is_y == 1
        src = batch.div_col_node.long()
        v0 = torch.where(is_y, stress[src, 2], stress[src, 0])
        v1 = torch.where(is_y, stress[src, 1], stress[src, 2])
        contrib = batch.div_data[:, None] * torch.stack([v0, v1], dim=-1)
        div = segment_sum(contrib, batch.div_row.long(), Np)

    node_type = batch.node_type[:, 0]
    keep = (node_type == 0) if zero_internal_boundary else (node_type != 1)
    return torch.where(keep[:, None], div, torch.zeros_like(div))


def per_graph_divergence(
    batch: GraphBatch, stress: torch.Tensor, reduce_strategy: str = "square"
) -> torch.Tensor:
    """Per-graph scalar divergence penalty, shape (G,): ``Σ_c mean_n(div_c²)``
    per graph, the node mean over ALL the graph's nodes (boundary rows are
    zeroed but still count)."""
    div = divergence_field(batch, stress, zero_internal_boundary=True)
    if reduce_strategy == "abs":
        red = div.abs()
    elif reduce_strategy == "square":
        red = div * div
    else:
        raise AttributeError("reduce_strategy must be 'abs' or 'square'")
    G = batch.n_graphs
    mask = batch.node_mask.to(stress.dtype)[:, None]
    per_graph = segment_sum(red * mask, batch.node_gid.long(), G + 1)[:G]
    count = torch.clamp(batch.graph_node_count.to(stress.dtype), min=1.0)
    return per_graph.sum(-1) / count


def batch_loss(
    batch: GraphBatch,
    prediction: torch.Tensor,
    ground_truth: torch.Tensor,
    divergence_penalty: float = 0.0,
    optimize_divergence: bool = False,
    group: Group | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Total batch loss = mean-over-real-graphs NMSE (+ λ·mean divergence);
    the reference sums per-graph losses and divides by the number of graphs
    in the batch. With ``group`` the batch is this rank's shard, and the
    sums and counts are summed over the ranks: the whole batch's loss."""
    gmask = batch.graph_mask.to(prediction.dtype)
    nmse_sum = psum((per_graph_nmse(batch, prediction, ground_truth) * gmask).sum(), group)
    n_real = torch.clamp(psum(gmask.sum(), group), min=1.0)
    nmse = nmse_sum / n_real
    aux = {"nmse": nmse}
    total = nmse
    if optimize_divergence:
        div_sum = psum((per_graph_divergence(batch, prediction) * gmask).sum(), group)
        div = (div_sum / n_real) * divergence_penalty
        aux["divergence"] = div
        total = total + div
    return total, aux


def partitioned_batch_loss(
    batch: GraphBatch,
    prediction: torch.Tensor,
    ground_truth: torch.Tensor,
    halo,
    group: Group,
    divergence_penalty: float = 0.0,
    optimize_divergence: bool = False,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """``batch_loss`` under edge partitioning (``parallel/partition.py``):
    ``batch`` is this rank's node range of the same graphs, so the per-graph
    segment sums (counts, target means, NMSE numerators and denominators,
    divergence partials) are summed over the ranks before the ratios. The
    divergence operator's columns (``div_col_node``) address the extended
    ``[local ++ ghost]`` rows: the prediction is exchanged once
    (``halo.exchange``). Returns the whole batch's loss on every rank."""
    G = batch.n_graphs
    gid = batch.node_gid.long()
    mask = batch.node_mask.to(prediction.dtype)[:, None]

    gt = ground_truth * mask
    pred = prediction * mask
    count = psum(segment_sum(mask, gid, G + 1), group)
    mean_gt = psum(segment_sum(gt, gid, G + 1), group) / torch.clamp(count, min=1.0)
    num = psum(segment_sum((gt - pred) ** 2 * mask, gid, G + 1), group)
    den = psum(segment_sum((gt - mean_gt[gid]) ** 2 * mask, gid, G + 1), group)
    nmse_per_graph = (num / torch.where(den == 0, torch.ones_like(den), den)).mean(-1)[:G]

    gmask = (count[:G, 0] > 0).to(prediction.dtype)
    n_real = torch.clamp(gmask.sum(), min=1.0)
    nmse = (nmse_per_graph * gmask).sum() / n_real
    aux = {"nmse": nmse}
    total = nmse
    if optimize_divergence:
        pred_ext = halo.exchange(prediction)
        is_y = batch.div_col_is_y == 1
        src = batch.div_col_node.long()
        v0 = torch.where(is_y, pred_ext[src, 2], pred_ext[src, 0])
        v1 = torch.where(is_y, pred_ext[src, 1], pred_ext[src, 2])
        contrib = batch.div_data[:, None] * torch.stack([v0, v1], dim=-1)
        div = segment_sum(contrib, batch.div_row.long(), prediction.shape[0])
        keep = (batch.node_type[:, 0] == 0)[:, None]
        div = torch.where(keep, div, torch.zeros_like(div))
        per_graph = psum(segment_sum(div * div * mask, gid, G + 1), group)[:G]
        div_per_graph = per_graph.sum(-1) / torch.clamp(count[:G, 0], min=1.0)
        div_loss = ((div_per_graph * gmask).sum() / n_real) * divergence_penalty
        aux["divergence"] = div_loss
        total = total + div_loss
    return total, aux
