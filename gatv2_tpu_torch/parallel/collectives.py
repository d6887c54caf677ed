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


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over the group (psum); differentiable."""
    if group_size(group) == 1:
        return x
    return _AllReduce.apply(x, group)
