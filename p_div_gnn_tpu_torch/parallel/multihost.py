"""Multi-process (multi-card, multi-host) set-up — the counterpart of
``p_div_gnn_tpu/parallel/multihost.py``.

JAX runs one process per host over the global device list after
``jax.distributed.initialize``; the port runs one process per card, wired
into one ``torch.distributed`` process group. ``ensure_distributed`` joins
it: explicit arguments win, then the variables ``torchrun`` sets (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``); with
neither it returns False (a single-process run). The data-parallel step of
``parallel/dp.py`` then runs unchanged across hosts: NCCL carries the
all-reduces over NVLink within a host and the network between hosts.

Each rank packs only its own shard for its own card (``pack_global_batch``).
"""

from __future__ import annotations

import os

import torch

from p_div_gnn_tpu_torch.graphs.batching import GraphSample
from p_div_gnn_tpu_torch.graphs.container import NODE_TILE, GraphBatch
from p_div_gnn_tpu_torch.parallel.dp import pack_sharded_batch, shard_of


def default_backend(device: str | torch.device | None = None) -> str:
    """NCCL for CUDA (one card per rank), gloo for the CPU."""
    if device is None:
        return "nccl" if torch.cuda.is_available() else "gloo"
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def local_device(device: str | torch.device = "cuda") -> torch.device:
    """The card of this rank: ``cuda:LOCAL_RANK`` for a bare ``"cuda"``
    (``torchrun`` sets ``LOCAL_RANK``); any other device as named."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return device


def ensure_distributed(
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    backend: str | None = None,
    verbose: bool = True,
) -> bool:
    """Join the default process group (idempotent); returns whether one is
    set up. ``init_method`` (e.g. ``tcp://host:port``), ``world_size`` and
    ``rank`` win over the ``torchrun`` variables; ``backend`` defaults to
    NCCL where CUDA is available, else gloo."""
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    if init_method is None:
        if "MASTER_ADDR" not in os.environ or "WORLD_SIZE" not in os.environ:
            return False
        init_method = "env://"
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    rank = int(os.environ["RANK"]) if rank is None else rank
    backend = backend or default_backend()
    if backend == "nccl":
        torch.cuda.set_device(local_device("cuda"))
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank)
    if verbose and rank == 0:
        print(f"torch.distributed: {world_size} ranks over {backend}", flush=True)
    return True


def pack_global_batch(
    samples: list[GraphSample],
    rank: int,
    world: int,
    graphs_per_shard: int | None = None,
    tile: int = NODE_TILE,
    device: str | torch.device = "cuda",
) -> GraphBatch:
    """This rank's shard of ``samples`` (the same list on every rank), on
    ``device``. The shards share their capacities, so every rank plans all
    of them, as each JAX process does, and keeps its own."""
    return shard_of(pack_sharded_batch(samples, world, graphs_per_shard, tile), rank).to(device)
