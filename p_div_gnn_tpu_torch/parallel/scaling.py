"""Weak-scaling harness: edges/s of the data-parallel train step at 1..N
cards — the counterpart of ``p_div_gnn_tpu/parallel/scaling.py`` (the
north star's "≥80 % edges/s scaling efficiency").

For each rank count n the flagship train step (``parallel/dp.py``) runs
over n ranks, each carrying the same ``samples_per_device`` graphs, so the
work grows with n and perfect scaling keeps the step time constant. One
rank runs in this process; more are spawned (``parallel/launch.py``), one
per card over NCCL (``cuda``), or on the CPU over gloo, where the numbers
show the semantics only and are no performance claim.
"""

from __future__ import annotations

import time

import torch

from p_div_gnn_tpu_torch.graphs.container import NormStats
from p_div_gnn_tpu_torch.models.epd import EncodeProcessDecode
from p_div_gnn_tpu_torch.parallel.dp import make_dp_train_step, pack_sharded_batch, shard_of
from p_div_gnn_tpu_torch.parallel.launch import run_ranks
from p_div_gnn_tpu_torch.parallel.multihost import default_backend


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def dp_step_seconds(rank: int, world: int, group, samples_per_device: list, latent_size: int,
                    message_passing_steps: int, iters: int, stats: NormStats,
                    device_type: str) -> float:
    """Mean wall seconds of one data-parallel train step (after one warm-up
    step) on this rank's shard of ``samples_per_device * world``."""
    device = torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")
    model = EncodeProcessDecode(latent_size=latent_size,
                                message_passing_steps=message_passing_steps,
                                generator=torch.Generator().manual_seed(0)).to(device)
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-3)
    stacked = pack_sharded_batch(samples_per_device * world, world, len(samples_per_device))
    batch = shard_of(stacked, rank).to(device)
    step = make_dp_train_step(model, stats, optimizer, group, divergence_penalty=10.0,
                              optimize_divergence=True)
    step(batch)
    _synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        step(batch)
    _synchronize(device)
    return (time.perf_counter() - t0) / iters


def measure_dp_scaling(
    samples_per_device: list,
    device_counts: list[int] | None = None,
    latent_size: int = 128,
    message_passing_steps: int = 10,
    iters: int = 10,
    stats: NormStats | None = None,
    device: str | torch.device = "cuda",
) -> list[dict]:
    """Rows ``{"devices", "step_s", "edges_per_s", "efficiency"}`` for each
    rank count (default: 1, 2, 4, 8 up to the cards present; the efficiency
    is the per-rank rate over the first count's)."""
    device = torch.device(device)
    if device_counts is None:
        avail = torch.cuda.device_count() if device.type == "cuda" else 1
        device_counts = [n for n in (1, 2, 4, 8) if n <= avail]
    stats = stats or NormStats.ones()
    args = (samples_per_device, latent_size, message_passing_steps, iters, stats, device.type)
    edges_per_shard = sum(s.num_edges for s in samples_per_device)
    rows, base_rate = [], None
    for n in device_counts:
        if n == 1:
            step_s = dp_step_seconds(0, 1, None, *args)
        else:
            step_s = run_ranks(dp_step_seconds, n, *args, backend=default_backend(device))[0]
        rate = n * edges_per_shard / step_s
        if base_rate is None:
            base_rate = rate / n
        rows.append({"devices": n, "step_s": step_s, "edges_per_s": rate,
                     "efficiency": (rate / n) / base_rate})
    return rows
