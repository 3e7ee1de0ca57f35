"""Differentiable collectives over one mesh axis, the port's form of the
JAX package's `lax.all_to_all` / `psum` / `all_gather` / `pmax` inside
`shard_map`.

Each collective is its own `torch.autograd.Function`, so its transpose is
written out and the same on both backends:

  * `all_to_all` (equal splits of rows): backward is the reverse
    all_to_all, which for equal splits is the same exchange;
  * `all_reduce_sum`: backward is the identity. Each rank's loss holds the
    reduced total, and a rank differentiates only its own terms of it;
  * `all_gather` (tiled on dim 0): backward is a reduce-scatter, written as
    the sum of every rank's cotangent of which this rank keeps its slice;
  * `pmax`: no gradient.

A group of one rank (or `group=None`, a 1x1 mesh without
`torch.distributed`) makes each of them the identity: no copy, no call. Under NCCL the tensors stay on the card. gloo has no CUDA
all_to_all and no CUDA reduce-scatter, so under gloo every collective
copies CUDA tensors through host memory. `STATS["ops"]` counts each
collective's calls and those staged through the host by name; with
`STATS["timing"]` set (`reset_stats(timing=True)`), each call also
synchronises the device before and after and adds its host-clock seconds
(staging included) and the bytes of its input.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

STATS = {"timing": False, "ops": {}}


def reset_stats(timing: bool = False) -> None:
    STATS.update(timing=timing, ops={})


def host_staged(group) -> bool:
    """Whether this group's collectives copy CUDA tensors through the host
    (gloo)."""
    return group is not None and dist.get_backend(group) == "gloo"


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def trivial(group) -> bool:
    """Whether the group has one rank, so that every collective over it
    is the identity."""
    return group_size(group) == 1


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _run(name: str, op, x: torch.Tensor, group, n_out: int) -> torch.Tensor:
    """Run `op(out, inp)` on a copy of x (on the host under gloo for CUDA
    tensors); `out` has n_out times x's rows. Returns out on x's device."""
    staged = host_staged(group) and x.is_cuda
    t0 = None
    if STATS["timing"]:
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
    inp = x.detach().to("cpu") if staged else x.detach().contiguous()
    out = inp.new_empty((inp.shape[0] * n_out,) + tuple(inp.shape[1:]))
    op(out, inp)
    out = out.to(x.device, non_blocking=False) if staged else out
    st = STATS["ops"].setdefault(name, {"calls": 0, "host_staged_calls": 0,
                                        "bytes": 0, "seconds": 0.0})
    st["calls"] += 1
    st["host_staged_calls"] += int(staged)
    if t0 is not None:
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        st["seconds"] += time.perf_counter() - t0
        st["bytes"] += x.numel() * x.element_size()
    return out


def _a2a(x, group):
    return _run("all_to_all",
                lambda o, i: dist.all_to_all_single(o, i, group=group), x,
                group, 1)


def _sum(x, group):
    def op(o, i):
        o.copy_(i)
        dist.all_reduce(o, op=dist.ReduceOp.SUM, group=group)
    return _run("all_reduce_sum", op, x, group, 1)


def _gather(x, group):
    n = group_size(group)

    def op(o, i):
        dist.all_gather(list(o.chunk(n)), i, group=group)
    return _run("all_gather", op, x, group, n)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a(x, group)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group), None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        return _gather(x, group)

    @staticmethod
    def backward(ctx, g):
        r, n = group_rank(ctx.group), ctx.rows
        return _sum(g, ctx.group)[r * n:(r + 1) * n], None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Rows split in group-size equal blocks; block j goes to rank j, and
    the result holds the blocks every rank sent here, in rank order."""
    if trivial(group):
        return x
    return _AllToAll.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group; its gradient passes through unchanged."""
    if trivial(group):
        return x
    return _AllReduceSum.apply(x, group)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's x concatenated on dim 0 in rank order."""
    if trivial(group):
        return x
    return _AllGather.apply(x, group)


@torch.no_grad()
def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """The element-wise maximum over the group (no gradient)."""
    if trivial(group):
        return x

    def op(o, i):
        o.copy_(i)
        dist.all_reduce(o, op=dist.ReduceOp.MAX, group=group)
    return _run("pmax", op, x, group, 1)


@torch.no_grad()
def reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group, outside autograd."""
    return x if trivial(group) else _sum(x, group)


@torch.no_grad()
def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """`all_gather` outside autograd; a copy of x in a one-rank group
    (callers own what it returns)."""
    return x.clone() if trivial(group) else _gather(x, group)


@torch.no_grad()
def broadcast(x: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """Rank `src`'s x on every rank of the group (the world when group is
    None and `torch.distributed` is initialised)."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return x

    def op(o, i):
        o.copy_(i)
        dist.broadcast(o, src, group=group)
    return _run("broadcast", op, x,
                group if group is not None else dist.group.WORLD, 1)
