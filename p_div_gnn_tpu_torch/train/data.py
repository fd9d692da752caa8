"""Bucketed-padding loader over GraphSamples, and a prefetching iterator.

The counterpart of ``p_div_gnn_tpu/train/data.py:29-213``. Each epoch the
samples are (optionally) shuffled with ``numpy.random.default_rng(seed)``,
grouped into batches of ``batch_size`` and packed into padded GraphBatches
whose capacities come from one node-bucket ladder, with the edge and
divergence capacities tied to the node bucket: the same batches, in the same
order, as the JAX loader packs.

What the JAX loader keeps "device-resident" the port keeps as GraphBatches
on ``device``: an unshuffled loader's batches after their first epoch
(``cache_device_batches``), and every batch of one shuffled grouping with
``cache_groups`` (only the batch order is reshuffled per epoch). A kept
batch keeps its tensors, so the layout checks cached on them run once.
Other batches are yielded on the host; ``prefetch`` moves them.

``FixedGraphLoader`` feeds a model whose graph is fixed and whose samples
are node states over it (``graphs/typed.py::TypedSample``, GraphCast's): it
sends the graph to the device once, keeps every sample there, and yields
them one a step in a new seeded order each epoch, the order the JAX
loader's shuffle gives (one ``default_rng(seed)`` shuffling ``arange(n)``
each epoch).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

from p_div_gnn_tpu_torch.graphs.batching import (
    GraphSample,
    _bucket,
    _round_up,
    default_node_buckets,
    pack_batch,
)
from p_div_gnn_tpu_torch.graphs.container import EDGE_BLOCK, NODE_TILE, GraphBatch
from p_div_gnn_tpu_torch.utils.profiling import span


class GraphLoader:
    def __init__(
        self,
        samples: list[GraphSample],
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        tile: int = NODE_TILE,
        edges_per_node: int = 8,
        div_per_node: int = 16,
        cache_device_batches: bool | None = None,
        cache_groups: bool = False,
        pair_blocks: bool = False,
        sender_view: bool = True,
        reorder: str | None = "rcm",
        device: str | torch.device = "cuda",
    ):
        self.samples = samples
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.tile = tile
        # a deterministic (eval) loader packs the same batches every epoch
        self.cache_device_batches = (
            (not shuffle) if cache_device_batches is None else cache_device_batches)
        self.cache_groups = cache_groups
        self.pair_blocks = pair_blocks
        # the sender view feeds only the fused / hybrid sender gathers
        self.sender_view = sender_view
        # RCM node order: a no-op for the (permutation-equivariant) model that
        # keeps the sender view's gathers local
        self.reorder = reorder
        self.device = torch.device(device)
        self._device_cache: list[GraphBatch] | None = None
        self.node_buckets = default_node_buckets()
        # pair-blocked layouts pad each (receiver tile, sender tile) group,
        # ~1.9x the slots: the tied edge capacity doubles with them
        self.edges_per_node = edges_per_node * 2 if pair_blocks else edges_per_node
        self.div_per_node = div_per_node
        self._capacity_overflow_warned = False

    def __len__(self) -> int:
        return (len(self.samples) + self.batch_size - 1) // self.batch_size

    def _capacities(self, batch_samples: list[GraphSample]) -> tuple[int, int, int]:
        pad_nodes = _bucket(sum(s.num_nodes for s in batch_samples) + 1, self.tile,
                            self.node_buckets)
        pad_edges = _round_up(self.edges_per_node * pad_nodes, EDGE_BLOCK)
        pad_div = self.div_per_node * pad_nodes
        # a denser batch than the ladder assumes gets content-driven sizes
        tot_edges = sum(s.num_edges for s in batch_samples)
        tot_div = sum(s.num_div_entries for s in batch_samples)
        if tot_edges > pad_edges:
            pad_edges = _round_up(tot_edges, 4096)
        if tot_div > pad_div:
            pad_div = _round_up(tot_div, 4096)
        return pad_nodes, pad_edges, pad_div

    def _check_capacity(self, batch: GraphBatch, pad_edges: int) -> None:
        """Warn once if a packed layout outgrew its bucket's edge capacity."""
        if not self._capacity_overflow_warned and batch.num_edges_padded > pad_edges:
            self._capacity_overflow_warned = True
            print(f"GraphLoader: packed edge layout ({batch.num_edges_padded} slots) "
                  f"exceeded the bucket capacity ({pad_edges}); raise edges_per_node",
                  flush=True)

    def _pack(self, idx: Iterable[int]) -> GraphBatch:
        """One batch, traced as ``loader.pack`` with its real edges and
        edge slots."""
        with span("loader.pack") as sp:
            batch_samples = [self.samples[i] for i in idx]
            pad_nodes, pad_edges, pad_div = self._capacities(batch_samples)
            batch = pack_batch(
                batch_samples, n_graphs=self.batch_size, tile=self.tile,
                pad_nodes=pad_nodes, pad_edges=pad_edges, pad_div=pad_div,
                pair_blocks=self.pair_blocks, sender_view=self.sender_view,
                reorder=self.reorder,
            )
            self._check_capacity(batch, pad_edges)
            sp.set(edges=sum(s.num_edges for s in batch_samples),
                   slots=batch.num_edges_padded)
        return batch

    def _groups(self) -> Iterator[np.ndarray]:
        order = np.arange(len(self.samples))
        if self.shuffle:
            self.rng.shuffle(order)
        for start in range(0, len(order), self.batch_size):
            yield order[start : start + self.batch_size]

    def __iter__(self) -> Iterator[GraphBatch]:
        if self._device_cache is not None:
            if self.cache_groups and self.shuffle:
                for i in self.rng.permutation(len(self._device_cache)):
                    yield self._device_cache[i]
            else:
                yield from self._device_cache
            return
        if self.cache_groups:
            self._device_cache = [self._pack(idx).to(self.device) for idx in self._groups()]
            yield from self._device_cache
            return
        kept = []
        for idx in self._groups():
            batch = self._pack(idx)
            if self.cache_device_batches:
                batch = batch.to(self.device)
                kept.append(batch)
            yield batch
        if self.cache_device_batches:
            self._device_cache = kept


class FixedGraphLoader:
    def __init__(self, samples: list, shuffle: bool = True, seed: int = 0,
                 device: str | torch.device = "cuda"):
        if not samples:
            raise ValueError("FixedGraphLoader needs at least one sample")
        graph = samples[0].graph.to(device)
        if any(s.graph is not samples[0].graph for s in samples):
            raise ValueError("FixedGraphLoader's samples share one graph")
        self.samples = [dataclasses.replace(s, graph=graph).to(device) for s in samples]
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.samples)

    def __iter__(self) -> Iterator:
        order = np.arange(len(self.samples))
        if self.shuffle:
            self.rng.shuffle(order)
        for i in order:
            yield self.samples[i]


def prefetch(
    loader: Iterable[GraphBatch], device: str | torch.device, depth: int = 2
) -> Iterator[GraphBatch]:
    """The loader's batches on ``device``, packed and copied on a host thread
    at most ``depth`` batches ahead; host batches go to a CUDA device from
    pinned memory without waiting. Batches already there pass as they are.
    An exception in the thread is raised here. The consumer's wait for
    each batch is traced as ``loader.wait``."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    end = object()
    stop = threading.Event()

    def put(item: object) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker() -> None:
        try:
            for batch in loader:
                if not put(batch.to(device, non_blocking=True)):
                    return
        except Exception as exc:  # handed to the consumer, which raises it
            put(exc)
            return
        put(end)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            with span("loader.wait"):
                item = q.get()
            if item is end:
                break
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
        thread.join()
