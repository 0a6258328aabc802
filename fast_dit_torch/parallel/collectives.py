"""The collectives of the parallel trainer, and the autograd functions built
on them (counterparts of the collectives GSPMD inserts for
`fast_dit_tpu/parallel/mesh.py`'s shardings).

Four collectives over a process group: `all_reduce` (sum), `all_gather`
and `reduce_scatter` along any axis, and `broadcast`. Each calls
`torch.distributed` directly, on NCCL or gloo groups, with the tensor as it
is. PyTorch's backend table lists only broadcast and all-reduce for gloo
on CUDA tensors, but torch 2.11's gloo runs all four on CUDA tensors, fp32
and bf16 (checked on the H100 with two ranks on one card), so nothing is
staged through a host buffer. Point-to-point calls are another matter:
gloo's send and recv fail on CUDA tensors, so the pipeline's hand-offs and
the sequence-parallel ring copy them through host buffers (`through_host`).
A gloo call on a CUDA tensor waits for the device, so each one runs with
the CUDA sync debug mode off (`sync_exempt`); `exempt_ranges` counts them
and their seconds.

The autograd functions, each an identity where the group has one rank:

- `copy_to_group`: identity forward, all-reduce backward (Megatron's f), at
  the input of a column-parallel layer or of the experts;
- `reduce_from_group`: all-reduce forward, identity backward (Megatron's
  g), after a row-parallel layer or the experts' combine;
- `mean_over_group`: the group's mean forward, identity backward, for a
  statistic of the data shard that the loss needs over the global batch
  (the MoE load balance's f and p): each rank's gradient then carries the
  global term's full weight on its own shard, and the data-parallel
  average of the gradients makes it the global gradient;
- `gather_shard`: all-gather along an axis forward, reduce-scatter
  backward (an FSDP parameter shard to its full tensor);
- `broadcast_owned`: a tensor held by one rank of the group to every rank,
  its gradient summed back to that rank (an FSDP spec on the layer axis:
  whole blocks per rank).

`full(p)` is what a module reads in place of its parameter `p`: `p`, or the
FSDP shard's gather. Called inside a remat region, it gathers again in the
recompute, so a gathered weight lives no longer than its block.
"""

from __future__ import annotations

import contextlib
import time
from typing import Sequence

import torch
import torch.distributed as dist

__all__ = ["sync_exempt", "exempt_ranges", "through_host", "group_size", "group_rank",
           "all_reduce", "all_gather", "reduce_scatter", "broadcast", "copy_to_group",
           "reduce_from_group", "mean_over_group", "gather_shard", "broadcast_owned", "full"]

exempt_ranges = {"count": 0, "seconds": 0.0}


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


@contextlib.contextmanager
def sync_exempt(tensor: torch.Tensor, group):
    """Run the block with the CUDA sync debug mode off when a gloo
    collective takes a CUDA tensor (it waits for the device), else as it is."""
    if not (tensor.is_cuda and dist.get_backend(group) == "gloo"):
        yield
        return
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        exempt_ranges["count"] += 1
        exempt_ranges["seconds"] += time.perf_counter() - t0
        torch.cuda.set_sync_debug_mode(mode)


def through_host(tensor: torch.Tensor, group) -> bool:
    """Whether a point-to-point call must copy `tensor` through a host
    buffer: gloo's send and recv read the tensor's memory from the host, and
    fail on a CUDA tensor ("writev: Bad address", torch 2.11 on the H100,
    fp32 and bf16, send/recv, isend/irecv and batch_isend_irecv alike)."""
    return tensor.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(tensor: torch.Tensor, group) -> torch.Tensor:
    """Sum `tensor` over `group`, in place; returns it."""
    if group_size(group) == 1:
        return tensor
    with sync_exempt(tensor, group):
        dist.all_reduce(tensor, group=group)
    return tensor


def all_gather(tensor: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along `dim`, in group-rank order."""
    n = group_size(group)
    if n == 1:
        return tensor
    with sync_exempt(tensor, group):
        src = tensor.movedim(dim, 0).contiguous()
        out = src.new_empty((n * src.shape[0], *src.shape[1:]))
        dist.all_gather(list(out.chunk(n)), src, group=group)
        return out.movedim(0, dim)


def reduce_scatter(tensor: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's chunk along `dim` of the group's sum of `tensor`."""
    n = group_size(group)
    if n == 1:
        return tensor
    with sync_exempt(tensor, group):
        src = tensor.movedim(dim, 0).contiguous()
        out = src.new_empty((src.shape[0] // n, *src.shape[1:]))
        dist.reduce_scatter(out, list(src.chunk(n)), group=group)
        return out.movedim(0, dim)


def broadcast(tensor: torch.Tensor, src: int, group) -> torch.Tensor:
    """`tensor` of group rank `src` to every rank, in place; returns it."""
    if group_size(group) == 1:
        return tensor
    with sync_exempt(tensor, group):
        dist.broadcast(tensor, dist.get_global_rank(group, src), group=group)
    return tensor


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous().clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _MeanOverGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group) / group_size(group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherShard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter(grad, ctx.group, ctx.dim), None, None


class _BroadcastOwned(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, owner, shape):
        ctx.group, ctx.owner, ctx.local = group, owner, tuple(x.shape)
        full = x.clone() if group_rank(group) == owner else x.new_empty(shape)
        return broadcast(full, owner, group)

    @staticmethod
    def backward(ctx, grad):
        grad = all_reduce(grad.contiguous().clone(), ctx.group)
        if group_rank(ctx.group) != ctx.owner:
            grad = grad.new_zeros(ctx.local)
        return grad, None, None, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _ReduceFromGroup.apply(x, group)


def mean_over_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _MeanOverGroup.apply(x, group)


def gather_shard(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return x if group_size(group) == 1 else _GatherShard.apply(x, group, dim)


def broadcast_owned(x: torch.Tensor, group, owner: int,
                    shape: Sequence[int]) -> torch.Tensor:
    """`x` is the whole tensor on group rank `owner` and empty elsewhere."""
    return x if group_size(group) == 1 else _BroadcastOwned.apply(x, group, owner,
                                                                  tuple(shape))


def full(p: torch.Tensor) -> torch.Tensor:
    """The whole tensor of parameter `p` where a module uses it: `p` itself,
    or, for an FSDP shard, the gather `mesh.shard_params` attached to it
    (differentiable, so the shard's gradient is reduce-scattered)."""
    gather = getattr(p, "fsdp_gather", None)
    return p if gather is None else gather(p)
