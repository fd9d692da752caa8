"""Data-parallel training over a process group — the counterpart of
``p_div_gnn_tpu/parallel/dp.py``.

JAX runs one process over a mesh of devices: ``shard_map`` over
``Mesh('data')`` hands each device its row of a batch stacked on a leading
shard axis. The port runs one process per card (``torchrun``, or
``parallel/launch.py::run_ranks``): rank r holds row r of what
``pack_sharded_batch`` stacks (``shard_of``) and runs the same model on it.
So the JAX package's single-controller ``device_put_sharded_batch`` has no
counterpart: each rank moves its own shard to its own card.

Three collectives make the sharded step equal to the whole-batch step:
the graph-LN statistics and the zero early exit are summed over the ranks
(``EncodeProcessDecode.forward(..., group=)``), so are the loss's per-graph
sums and real-graph counts (``batch_loss(..., group=)``), and the gradients
are averaged (``pmean_``) before the replicated Adam update. The
transposes of the loss's sums sum the cotangents, so each rank's raw
gradient is D × its partial and their mean is the true gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator

import numpy as np
import torch

from p_div_gnn_tpu_torch.graphs.batching import GraphSample, pack_batch, pad_sender_view
from p_div_gnn_tpu_torch.graphs.container import NODE_TILE, GraphBatch, NormStats
from p_div_gnn_tpu_torch.losses import batch_loss
from p_div_gnn_tpu_torch.parallel.collectives import Group, pmean_


def stack_batches(batches: list[GraphBatch]) -> GraphBatch:
    """Host batches of equal capacities stacked on a leading shard axis
    (absent views stay None), as ``jax.tree.map(np.stack, ...)`` stacks
    them."""
    fields = {
        name: None if getattr(batches[0], name) is None
        else np.stack([np.asarray(getattr(b, name)) for b in batches])
        for name in batches[0].array_fields()
    }
    return dataclasses.replace(batches[0], **fields)


def shard_of(stacked: GraphBatch, rank: int) -> GraphBatch:
    """Row ``rank`` of a stacked host batch: that rank's local batch."""
    fields = {name: None if (v := getattr(stacked, name)) is None else v[rank]
              for name in stacked.array_fields()}
    return dataclasses.replace(stacked, **fields)


def _pad_ell(arr: np.ndarray, w: int, pad: int) -> np.ndarray:
    dw = w - arr.shape[1]
    return arr if dw == 0 else np.pad(arr, ((0, 0), (0, dw)), constant_values=pad)


def shard_assignment(samples: list[GraphSample], n_shards: int,
                     graphs_per_shard: int) -> list[list[int]]:
    """The sample indices of each shard, in their order there: the biggest
    first, each to the least-loaded shard with room."""
    shards: list[list[int]] = [[] for _ in range(n_shards)]
    loads = np.zeros(n_shards, dtype=np.int64)
    for i in np.argsort([-s.num_nodes for s in samples]):
        d = int(np.argmin(loads))
        if len(shards[d]) >= graphs_per_shard:
            d = int(np.argmin([len(s) for s in shards]))
        shards[d].append(int(i))
        loads[d] += samples[i].num_nodes
    return shards


def pack_sharded_batch(
    samples: list[GraphSample],
    n_shards: int,
    graphs_per_shard: int | None = None,
    tile: int = NODE_TILE,
) -> GraphBatch:
    """Pack samples into ``n_shards`` local batches of equal capacities,
    stacked on a leading shard axis (``shard_assignment``: by size, for
    balance): array-equal to the JAX package's."""
    gps = graphs_per_shard or (len(samples) + n_shards - 1) // n_shards
    shards = [[samples[i] for i in idx] for idx in shard_assignment(samples, n_shards, gps)]
    # capacities common to every shard
    pad_nodes = max(
        ((sum(s.num_nodes for s in sh) + 1 + tile - 1) // tile + 1) * tile for sh in shards)
    pad_edges = max(((max(sum(s.num_edges for s in sh), 1) + 511) // 512) * 512
                    for sh in shards)
    pad_div = max(((max(sum(s.num_div_entries for s in sh), 1) + 511) // 512) * 512
                  for sh in shards)

    def pack_all(edge_cap: int) -> list[GraphBatch]:
        return [pack_batch(sh, n_graphs=gps, pad_nodes=pad_nodes, pad_edges=edge_cap,
                           pad_div=pad_div, tile=tile) for sh in shards]

    packed = pack_all(pad_edges)
    # block alignment can grow one shard's edge capacity: equalize
    caps = {b.num_edges_padded for b in packed}
    if len(caps) > 1:
        packed = pack_all(max(caps))
    vcap = max(len(b.snd_perm) for b in packed)
    packed = [dataclasses.replace(b, **dict(zip(
        ("snd_perm", "snd_sorted", "snd_block_tile"),
        pad_sender_view(b.snd_perm, b.snd_sorted, b.snd_block_tile, vcap,
                        b.num_nodes_padded, tile))))
        for b in packed]
    # the divergence ELL fan-in widths too (padding slots point at the
    # shard's last padding node with value 0)
    if packed[0].div_src is not None:
        w = max(b.div_src.shape[1] for b in packed)
        wt = max(b.divT_row.shape[1] for b in packed)
        packed = [dataclasses.replace(
            b,
            div_src=_pad_ell(b.div_src, w, b.num_nodes_padded - 1),
            div_val=_pad_ell(b.div_val, w, 0),
            div_isy=_pad_ell(b.div_isy, w, 0),
            divT_row=_pad_ell(b.divT_row, wt, b.num_nodes_padded - 1),
            divT_val=_pad_ell(b.divT_val, wt, 0),
            divT_isy=_pad_ell(b.divT_isy, wt, 0),
        ) for b in packed]
    return stack_batches(packed)


class DPGraphLoader:
    """Shuffled loader of this rank's shards (the data-parallel counterpart
    of ``GraphLoader``): every rank draws the same order from ``seed``,
    packs the same ``pack_sharded_batch`` and yields its own row, moved to
    ``device``."""

    def __init__(
        self,
        samples: list[GraphSample],
        batch_size: int,
        rank: int,
        world: int,
        shuffle: bool = False,
        seed: int = 0,
        device: str | torch.device = "cuda",
    ):
        if batch_size % world:
            raise ValueError(f"batch_size {batch_size} must divide across {world} ranks")
        self.samples = samples
        self.batch_size = batch_size
        self.rank, self.world = rank, world
        self.graphs_per_shard = batch_size // world
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.device = torch.device(device)

    def __len__(self) -> int:
        return (len(self.samples) + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[GraphBatch]:
        order = np.arange(len(self.samples))
        if self.shuffle:
            self.rng.shuffle(order)
        for start in range(0, len(order), self.batch_size):
            idx = order[start:start + self.batch_size]
            stacked = pack_sharded_batch([self.samples[i] for i in idx], self.world,
                                         self.graphs_per_shard)
            yield shard_of(stacked, self.rank).to(self.device)


def make_dp_train_step(
    model: torch.nn.Module,
    stats: NormStats,
    optimizer: torch.optim.Optimizer,
    group: Group,
    divergence_penalty: float = 0.0,
    optimize_divergence: bool = False,
) -> Callable[[GraphBatch], dict[str, torch.Tensor]]:
    """The data-parallel train step: ``step(local_batch)`` runs the forward
    and the whole batch's loss on this rank's shard, the backward, the
    gradients' mean over the ranks and the replicated Adam update; returns
    the loss terms (the same on every rank)."""

    def step(batch: GraphBatch) -> dict[str, torch.Tensor]:
        model.zero_grad(set_to_none=True)
        pred = model(batch, stats, scale_input=True, scale_output=False, group=group)
        gt = (batch.local_stress - stats.mean_local_stress) / stats.std_local_stress
        total, aux = batch_loss(batch, pred, gt, divergence_penalty, optimize_divergence, group)
        total.backward()
        pmean_([p.grad for p in model.parameters()], group)
        optimizer.step()
        return {**{k: v.detach() for k, v in aux.items()}, "total": total.detach()}

    return step


def make_dp_eval_step(
    model: torch.nn.Module, stats: NormStats, group: Group
) -> Callable[[GraphBatch], torch.Tensor]:
    """``eval(local_batch)``: this rank's (Np, 3) prediction, in stress units,
    with the whole batch's graph-LN statistics."""

    @torch.no_grad()
    def evaluate(batch: GraphBatch) -> torch.Tensor:
        return model(batch, stats, scale_input=True, scale_output=True, group=group)

    return evaluate
