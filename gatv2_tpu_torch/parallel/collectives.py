"""Collectives with gradients for the sharded layers, as
torch.autograd.Functions (the port's counterpart of the transposes JAX's
shard_map derives).

Every rank differentiates its own share of the loss, and the shares sum
to the loss (parallel/sharded.py), so each collective's backward is its
exact adjoint:

  all_gather    (dense halo over 'graph', head concat over 'head')
                -> reduce-scatter: a rank's slice gets the sum of every
                   peer's gradient of that slice;
  all_to_all    (boundary halo)  -> the reverse all_to_all;
  all_reduce    (head psum of the last layer) -> all_reduce.

The overlap layer splits the boundary all_to_all into its start
(all_to_all_start, async_op=True) and its wait (PendingAllToAll.wait), so
that the local pass runs while the rows are in flight. With NCCL, wait()
orders the current stream after the transfer and does not block the host;
with gloo it blocks the host until the rows have arrived.

A group of one rank moves nothing. The same calls serve NCCL and gloo:
gloo takes CUDA tensors for all_reduce, broadcast, all_gather_into_tensor,
reduce_scatter_tensor and all_to_all_single (torch 2.11 on an H100;
chip_smoke.py's rank_transport checks each on every run) and routes them
through host memory itself, so nothing is staged here.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return dist.get_world_size(group)


def all_gather_dim0(x: torch.Tensor, group) -> torch.Tensor:
    """[n, ...] per rank -> [S*n, ...], rank order."""
    s = group_size(group)
    if s == 1:
        return x
    out = x.new_empty((s * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def reduce_scatter_dim0(x: torch.Tensor, group) -> torch.Tensor:
    """[S*n, ...] per rank -> [n, ...]: the sum over ranks of slice r."""
    s = group_size(group)
    if s == 1:
        return x
    out = x.new_empty((x.shape[0] // s, *x.shape[1:]))
    dist.reduce_scatter_tensor(out, x.contiguous(), group=group)
    return out


def all_to_all_dim0(x: torch.Tensor, group) -> torch.Tensor:
    """[S, ...] per rank -> [S, ...]: out[j] on rank r = x[r] on rank j."""
    if group_size(group) == 1:
        return x
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


class PendingAllToAll:
    """An all_to_all_dim0 in flight (all_to_all_start). It holds the send
    buffer and the output until wait() returns: gloo copies CUDA tensors
    off the current stream, so neither may be freed before then. Every
    start must be waited on, also when the work between start and wait
    raises, or the ranks' collective order breaks."""

    def __init__(self, send: torch.Tensor, out: torch.Tensor, work, group):
        self._send, self._out, self._work = send, out, work
        self.group = group

    def wait(self) -> torch.Tensor:
        """The exchanged tensor, out[j] on rank r = send[r] on rank j."""
        if self._work is not None:
            self._work.wait()
            self._work = self._send = None
        return self._out


def all_to_all_start(x: torch.Tensor, group) -> PendingAllToAll:
    """Start all_to_all_dim0(x) and return at once; not differentiable
    (all_to_all_wait is)."""
    send = x.detach().contiguous()
    if group_size(group) == 1:
        return PendingAllToAll(send, send, None, group)
    out = torch.empty_like(send)
    work = dist.all_to_all_single(out, send, group=group, async_op=True)
    return PendingAllToAll(send, out, work, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """A new tensor holding the sum of x over the group's ranks."""
    if group_size(group) == 1:
        return x
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_dim0(x, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim0(g, ctx.group), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all_dim0(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all_dim0(g, ctx.group), None


class _AllToAllWait(torch.autograd.Function):
    """The wait of an all_to_all started on x, with the reverse all_to_all
    as its backward (run when autograd reaches it, as _AllToAll's)."""

    @staticmethod
    def forward(ctx, x, pending):
        ctx.group = pending.group
        return pending.wait()

    @staticmethod
    def backward(ctx, g):
        return all_to_all_dim0(g, ctx.group), None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Concatenate every rank's x along `dim` (rank order);
    differentiable, the backward a reduce-scatter."""
    if group_size(group) == 1:
        return x
    return _AllGather.apply(x.movedim(dim, 0), group).movedim(0, dim)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Route x[j] ([S, ...] per rank) to rank j; differentiable."""
    return _AllToAll.apply(x, group)


def all_to_all_wait(x: torch.Tensor,
                    pending: PendingAllToAll) -> torch.Tensor:
    """pending.wait() for the all_to_all_start(x, group) that made
    `pending`; differentiable in x, as all_to_all(x, group) is."""
    return _AllToAllWait.apply(x, pending)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over the group (psum); differentiable."""
    if group_size(group) == 1:
        return x
    return _AllReduce.apply(x, group)
