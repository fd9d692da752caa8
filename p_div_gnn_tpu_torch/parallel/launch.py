"""Start ranks on one machine without ``torchrun``: ``run_ranks`` spawns one
process per rank (``torch.multiprocessing``, start method ``spawn``), joins
them into a process group over a loopback TCP store and returns what each
rank's function returned. The weak-scaling harness, the tests and
``chip_smoke.py`` start their ranks so.

The function must be importable by name (defined at a module's top level)
and return picklable values (numpy arrays, numbers, CPU tensors: they come
back by value).
"""

from __future__ import annotations

import datetime
import os
import pickle
import socket
from typing import Any, Callable

COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=5)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn: Callable, world: int, backend: str, port: int, args: tuple,
               results: Any) -> None:
    import torch
    import torch.distributed as dist

    # what torchrun tells a rank about itself
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world))
    if backend == "nccl":
        torch.cuda.set_device(rank)  # NCCL takes one card per rank
    # the ranks share this machine's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    # a collective whose peer has failed raises after COLLECTIVE_TIMEOUT
    # instead of waiting for it
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank, timeout=COLLECTIVE_TIMEOUT)
    out = fn(rank, world, dist.group.WORLD, *args)
    # plain pickle: torch.multiprocessing would send a tensor as a handle to
    # this process's shared memory, gone once it exits
    results.put((rank, pickle.dumps(out)))
    dist.barrier()
    dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, *args: Any, backend: str = "gloo") -> list[Any]:
    """``fn(rank, world, group, *args)`` on ``world`` spawned ranks; returns
    their results in rank order. A rank's exception is raised here (the
    other ranks are then stopped)."""
    import torch.multiprocessing as mp

    results = mp.get_context("spawn").SimpleQueue()
    ctx = mp.start_processes(_rank_main, args=(fn, world, backend, free_port(), args, results),
                             nprocs=world, join=False, start_method="spawn")
    got: dict[int, Any] = {}
    done = False
    while not done:
        done = ctx.join(timeout=0.05)
        # drain while the ranks run: a large result must not wait on the pipe
        while not results.empty():
            r, out = results.get()
            got[r] = pickle.loads(out)
    return [got[r] for r in range(world)]
