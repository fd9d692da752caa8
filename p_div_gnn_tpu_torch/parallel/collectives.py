"""Collectives of the parallel tier over a ``torch.distributed`` process
group — the counterparts of the ``jax.lax`` collectives that the JAX
package's ``shard_map`` code uses, each with JAX's transpose as its
backward:

- ``psum`` ↔ all-reduce (sum); its backward all-reduces the cotangent
  (``psum64`` sums in fp64, for the moment sums);
- ``all_to_all`` (tiled: split and concat on axis 0) ↔ ``all_to_all_single``;
  its backward is the same exchange of the cotangent blocks;
- ``all_gather`` (stacked on a new axis 0) ↔ ``all_gather_into_tensor``;
  its backward is a sum-reduce-scatter, written as an ``all_to_all`` of the
  cotangent blocks followed by a sum over the received blocks in rank
  order: the same arithmetic on every backend (gloo has no reduce-scatter
  in every version) and the same order on every rank;
- ``pmean_`` of gradients, in place and outside autograd.

With ``group=None`` every function is the identity, so single-card code
runs unchanged. The normalisation contract is JAX's: a sharded loss is the
global loss (its sums and counts all-reduced), the transposes sum the
cotangents, so each rank's raw gradient is D × its partial, and ``pmean_``
of the gradients gives back the true gradient (``parallel/dp.py:200-215``
and ``parallel/partition.py:344-356`` of the JAX package).

``start_all_to_all`` / ``start_all_gather`` issue the exchange without
waiting (``async_op=True``) and return a ``Pending`` whose ``wait`` gives
the result with its backward attached, so a caller can run local work while
the exchange is in flight. On a gloo group a CUDA tensor is staged through
host memory (``staged_through_host``): gloo's CUDA support differs between
collectives and versions, so the gloo branch always copies; NCCL takes the
device buffers as they are.

``torch.distributed`` is imported inside the functions, so the package
imports where it is unavailable.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

import torch

Group = Any  # a torch.distributed ProcessGroup


def world_size(group: Group | None) -> int:
    if group is None:
        return 1
    import torch.distributed as dist

    return dist.get_world_size(group)


def rank(group: Group | None) -> int:
    if group is None:
        return 0
    import torch.distributed as dist

    return dist.get_rank(group)


def barrier(group: Group | None) -> None:
    if group is not None:
        import torch.distributed as dist

        dist.barrier(group=group)


def staged_through_host(t: torch.Tensor, group: Group | None) -> bool:
    """Whether a collective of ``t`` on ``group`` copies it through host
    memory: CUDA tensors on a gloo group."""
    if group is None or not t.is_cuda:
        return False
    import torch.distributed as dist

    return dist.get_backend(group) == "gloo"


class Pending:
    """A collective in flight: ``wait`` returns its output on the input's
    device, with the collective's transpose as its backward."""

    def __init__(self, x: torch.Tensor, out: torch.Tensor, work: Any,
                 transpose: Callable[[torch.Tensor, Group], torch.Tensor], group: Group):
        self.x, self.out, self.work = x, out, work
        self.transpose, self.group = transpose, group

    def result(self) -> torch.Tensor:
        if self.work is not None:
            self.work.wait()
            self.work = None
        return self.out.to(self.x.device)

    def wait(self) -> torch.Tensor:
        return _Collective.apply(self.x, self)


class _Collective(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pending):
        ctx.transpose, ctx.group = pending.transpose, pending.group
        return pending.result()

    @staticmethod
    def backward(ctx, g):
        return ctx.transpose(g.contiguous(), ctx.group), None


def _launch(kind: str, x: torch.Tensor, out_shape: tuple[int, ...], group: Group,
            async_op: bool) -> tuple[torch.Tensor, Any]:
    import torch.distributed as dist

    src = x.detach().contiguous()
    if staged_through_host(x, group):
        src = src.cpu()
    out = torch.empty(out_shape, dtype=x.dtype, device=src.device)
    if kind == "all_gather":
        # the ranks' blocks are written one after another along axis 0
        out = out.view((world_size(group),) + tuple(x.shape))
    if kind == "all_reduce":
        out.copy_(src)
        work = dist.all_reduce(out, group=group, async_op=async_op)
    elif kind == "all_to_all":
        work = dist.all_to_all_single(out, src, group=group, async_op=async_op)
    else:
        # all_gather_single is the newer name of all_gather_into_tensor
        gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
        work = gather(out.flatten(0, 1), src, group=group, async_op=async_op)
    return out, work if async_op else None


def _all_reduce_now(g: torch.Tensor, group: Group) -> torch.Tensor:
    out, _ = _launch("all_reduce", g, tuple(g.shape), group, False)
    return out.to(g.device)


def _all_to_all_now(g: torch.Tensor, group: Group) -> torch.Tensor:
    out, _ = _launch("all_to_all", g, tuple(g.shape), group, False)
    return out.to(g.device)


def _reduce_scatter_now(g: torch.Tensor, group: Group) -> torch.Tensor:
    # rank r receives every rank's cotangent of its own block, in rank order
    return _all_to_all_now(g, group).sum(0)


def psum(x: torch.Tensor, group: Group | None) -> torch.Tensor:
    """Sum of ``x`` over the group's ranks (``jax.lax.psum``)."""
    if group is None:
        return x
    out, _ = _launch("all_reduce", x, tuple(x.shape), group, False)
    return Pending(x, out, None, _all_reduce_now, group).wait()


def psum64(x: torch.Tensor, group: Group | None) -> torch.Tensor:
    """``psum`` taken in fp64 and rounded once to ``x``'s dtype."""
    if group is None:
        return x
    return psum(x.double(), group).to(x.dtype)


def start_all_to_all(x: torch.Tensor, group: Group) -> Pending:
    """Issue the tiled all-to-all of ``x`` (D, ...): block r goes to rank r,
    and block o of the result came from rank o."""
    if x.shape[0] != world_size(group):
        raise ValueError(f"all_to_all: {x.shape[0]} blocks for {world_size(group)} ranks")
    out, work = _launch("all_to_all", x, tuple(x.shape), group, True)
    return Pending(x, out, work, _all_to_all_now, group)


def start_all_gather(x: torch.Tensor, group: Group) -> Pending:
    """Issue the all-gather of ``x``: the result (D, ...) holds rank o's
    ``x`` in block o."""
    out, work = _launch("all_gather", x, (world_size(group) * x.shape[0],) + tuple(x.shape[1:]),
                        group, True)
    return Pending(x, out, work, _reduce_scatter_now, group)


def all_to_all(x: torch.Tensor, group: Group | None) -> torch.Tensor:
    if group is None:
        return x
    return start_all_to_all(x, group).wait()


def all_gather(x: torch.Tensor, group: Group | None) -> torch.Tensor:
    if group is None:
        return x[None]
    return start_all_gather(x, group).wait()


@torch.no_grad()
def pmean_(tensors: Iterable[torch.Tensor], group: Group | None) -> None:
    """Replace each tensor by its mean over the group's ranks (``jax.lax.pmean``
    of the gradients), through one all-reduce of their concatenation."""
    tensors = [t for t in tensors if t is not None]
    if group is None or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    total = _all_reduce_now(flat, group) / world_size(group)
    offset = 0
    for t in tensors:
        t.copy_(total[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
