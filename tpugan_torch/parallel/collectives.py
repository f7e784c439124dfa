"""Differentiable collectives: what XLA's SPMD partitioner inserts for the
JAX package on its own, written out for one process per rank.

A tensor on a rank is either *replicated* over a group (every rank holds
the same values) or *sharded* (each rank holds its part: a slice, or a
partial sum).  Gradients follow the same rule: the cotangent of a
replicated tensor is replicated, that of a sharded one is this rank's
part.  Each function below moves a tensor across that line, and its
backward is the conjugate move (Megatron-LM's ``f``/``g`` pairs), so
autograd composes them to any order (WGAN-GP's double backward):

- ``all_reduce_sum``: partial sums -> their sum, consumed by sharded
  compute (BatchNorm's batch statistics); backward all-reduces too.
- ``gather_from_shard``: enter a replicated region from a sharded one
  (forward all_gather along ``dim``; backward takes this rank's slice).
- ``shard_of``: enter a sharded region from a replicated one (forward takes
  this rank's slice; backward all-gathers).
- ``feed_sharded``: a replicated parameter into sharded compute (forward
  identity; backward all-reduces its partial gradients).
- ``halo``: the neighbours' edge rows along ``dim``, zero at the group's
  ends (the spatial convs' one-row halo); backward sends each row's
  cotangent back to the rank that owns it.

Every collective is an ``all_reduce`` or an ``all_gather``: both backends
take both for CPU and CUDA tensors (gloo's point-to-point and
reduce-scatter are not relied on).  ``torch.distributed.nn.functional``
(deprecated) is not used.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def all_gather(x: torch.Tensor, group) -> list:
    """Every rank's ``x`` in ``group``, in rank order (no gradient)."""
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x, group=group)
    return out


def _reduced(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of ``x``, in a new contiguous tensor (NCCL
    refuses a strided one: a permuted weight's gradient is)."""
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=group)
    return y


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduced(x, group)

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    """Forward all-reduce, backward identity (``feed_sharded``'s
    conjugate)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduced(x, group)

    @staticmethod
    def backward(ctx, g):
        return _Feed.apply(g, ctx.group), None


class _Feed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _Reduce.apply(g, ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return torch.cat(all_gather(x, group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return _Slice.apply(g, ctx.group, ctx.dim), None, None


class _Slice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n = dist.get_world_size(group)
        if x.shape[dim] % n:
            raise ValueError(f"extent {x.shape[dim]} of dim {dim} is not "
                             f"divisible by the group's {n} ranks")
        k = x.shape[dim] // n
        return x.narrow(dim, dist.get_rank(group) * k, k).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _Gather.apply(g, ctx.group, ctx.dim), None, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduceSum.apply(x, group)


def gather_from_shard(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return _Gather.apply(x, group, dim)


def shard_of(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return _Slice.apply(x, group, dim)


def feed_sharded(x: torch.Tensor, group) -> torch.Tensor:
    return _Feed.apply(x, group)


def _edges(x, dim):
    size = x.shape[dim]
    return x.narrow(dim, 0, 1), x.narrow(dim, size - 1, 1)


class _Halo(torch.autograd.Function):
    """(up, down): rank r's ``up`` is rank r-1's last row, ``down`` rank
    r+1's first row; zeros at the group's ends (the global borders)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        first, last = _edges(x, dim)
        parts = all_gather(torch.cat([first, last], dim=dim), group)
        r, n = dist.get_rank(group), len(parts)
        zero = torch.zeros_like(first)
        up = parts[r - 1].narrow(dim, 1, 1) if r > 0 else zero
        down = parts[r + 1].narrow(dim, 0, 1) if r < n - 1 else zero
        ctx.shape = x.shape
        return up.contiguous(), down.contiguous()

    @staticmethod
    def backward(ctx, g_up, g_down):
        return _HaloAdjoint.apply(g_up, g_down, ctx.group, ctx.dim,
                                  ctx.shape), None, None


class _HaloAdjoint(torch.autograd.Function):
    """``_Halo``'s transpose: rank r's last row takes rank r+1's ``up``
    cotangent, its first row rank r-1's ``down`` cotangent."""

    @staticmethod
    def forward(ctx, g_up, g_down, group, dim, shape):
        ctx.group, ctx.dim = group, dim
        parts = all_gather(torch.cat([g_up, g_down], dim=dim), group)
        r, n = dist.get_rank(group), len(parts)
        dx = g_up.new_zeros(shape)
        if r > 0:
            dx.narrow(dim, 0, 1).add_(parts[r - 1].narrow(dim, 1, 1))
        if r < n - 1:
            dx.narrow(dim, shape[dim] - 1, 1).add_(
                parts[r + 1].narrow(dim, 0, 1))
        return dx

    @staticmethod
    def backward(ctx, g):
        up, down = _Halo.apply(g, ctx.group, ctx.dim)
        return up, down, None, None, None


def halo(x: torch.Tensor, group, dim: int):
    """(up, down) one-row halos of ``x`` along ``dim`` from its neighbours
    in ``group``."""
    return _Halo.apply(x, group, dim)


def all_reduce_grads(params, group) -> None:
    """Sum the gradients of ``params`` over ``group`` as one flattened,
    coalesced buffer (parameters without a gradient are skipped)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()
