"""Sequence (context) parallelism: one sample's tokens split into shards
around a ring.

Counterpart of `fast_dit_tpu/parallel/sequence.py`. LayerNorm, adaLN
modulation, the MLP and the projections are per token, so the only op of a
DiT block that sees the whole sequence is attention, which runs as exact
ring attention (`ops/ring_attention.py`). A ring holds n contiguous token
shards in ring order and knows how to move a key/value block to the next
shard:

- `LocalRing(n)`: all n shards on one device, stacked on the batch axis,
  shard-major: a (B, N, D) tensor becomes (n * B, N / n, D). Rotating is a
  roll of the shard axis, and autograd's transpose of it is the reverse
  roll. One ring step is one kernel launch over all n shards, so each layer
  launches each hop kernel n times, as each card of an n-card ring would.
  The counterpart of the JAX tests' virtual-device mesh.
- `ProcessGroupRing(group)`: rank r of a `torch.distributed` group holds
  shard r. Rotating sends to rank r + 1 and receives from rank r - 1
  (`batch_isend_irecv`; a CUDA tensor on gloo through host buffers,
  `collectives.through_host`); the backward sends the other way, the
  transpose of `ppermute`.

Both forwards are differentiable end to end. Under a process ring the
parameter gradients on each rank are that rank's partials (the tokens of
its shard); the caller sums them over the group, as DDP's all-reduce does.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .collectives import sync_exempt, through_host

__all__ = ["LocalRing", "ProcessGroupRing", "create_seq_groups", "sequence_parallel_stack",
           "dit_sequence_parallel_forward"]


class LocalRing:
    """n token shards in ring order on one device, stacked shard-major on
    the batch axis."""

    def __init__(self, n: int):
        if n < 1:
            raise ValueError(f"a ring has at least one shard, got {n}")
        self.size = n

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """(B, N, ...) -> (n * B, N / n, ...): shard i of batch row b at row
        i * B + b."""
        B, N = x.shape[:2]
        if N % self.size:
            raise ValueError(f"{N} tokens do not split into {self.size} shards")
        x = x.reshape(B, self.size, N // self.size, *x.shape[2:]).transpose(0, 1)
        return x.reshape(self.size * B, N // self.size, *x.shape[3:])

    def unshard(self, x: torch.Tensor) -> torch.Tensor:
        """The inverse of `shard`."""
        nB, S = x.shape[:2]
        x = x.reshape(self.size, nB // self.size, S, *x.shape[2:]).transpose(0, 1)
        return x.reshape(nB // self.size, self.size * S, *x.shape[3:])

    def expand(self, c: torch.Tensor) -> torch.Tensor:
        """A per-sample (B, ...) conditioner for every shard's rows."""
        return c.repeat(self.size, *([1] * (c.dim() - 1)))

    def rotate(self, t: torch.Tensor) -> torch.Tensor:
        """Shard i's block to shard i + 1 (mod n): a roll of the shard axis."""
        return torch.roll(t.reshape(self.size, -1, *t.shape[1:]), 1, dims=0).reshape(t.shape)


class _Rotate(torch.autograd.Function):
    """Send to rank r + shift, receive from rank r - shift; the backward
    rotates the cotangent the other way."""

    @staticmethod
    def forward(ctx, t, ring, shift):
        ctx.ring, ctx.shift = ring, shift
        return ring._sendrecv(t, shift)

    @staticmethod
    def backward(ctx, grad):
        return ctx.ring._sendrecv(grad, -ctx.shift), None, None


class _GatherTokens(torch.autograd.Function):
    """All-gather the shards along the token axis. The backward keeps this
    rank's slice of the cotangent and sums nothing: every rank holds the same
    gathered tensor, so each rank's backward covers its own shard, and the
    per-rank partials sum to the gradient."""

    @staticmethod
    def forward(ctx, x, ring):
        ctx.ring = ring
        parts = [torch.empty_like(x) for _ in range(ring.size)]
        dist.all_gather(parts, x.contiguous(), group=ring.group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, grad):
        return grad.chunk(ctx.ring.size, dim=1)[ctx.ring.rank].contiguous(), None


class ProcessGroupRing:
    """Rank r of a `torch.distributed` group: shard r of the tokens."""

    def __init__(self, group=None):
        self.group = dist.group.WORLD if group is None else group
        self.size = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)

    def _peer(self, offset: int) -> int:
        return dist.get_global_rank(self.group, (self.rank + offset) % self.size)

    def _sendrecv(self, t: torch.Tensor, shift: int) -> torch.Tensor:
        t = t.contiguous()
        host = through_host(t, self.group)
        with sync_exempt(t, self.group):
            src = t.cpu() if host else t
            out = torch.empty_like(src)
            ops = [dist.P2POp(dist.isend, src, self._peer(shift), self.group),
                   dist.P2POp(dist.irecv, out, self._peer(-shift), self.group)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            return out.to(t.device) if host else out

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a (B, N, ...) tensor every rank holds whole."""
        N = x.shape[1]
        if N % self.size:
            raise ValueError(f"{N} tokens do not split into {self.size} shards")
        S = N // self.size
        return x[:, self.rank * S:(self.rank + 1) * S]

    def unshard(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's shard, gathered along the token axis."""
        return _GatherTokens.apply(x, self)

    def expand(self, c: torch.Tensor) -> torch.Tensor:
        return c

    def rotate(self, t: torch.Tensor) -> torch.Tensor:
        """Send to rank r + 1, receive rank r - 1's block."""
        if self.size == 1:
            return t
        return _Rotate.apply(t, self, 1)


def create_seq_groups(seq: int, data: int = 1):
    """(seq group, data group) of this rank, the counterpart of
    `create_seq_mesh` (:32-40): ranks [d * seq, (d + 1) * seq) form the d-th
    seq group, seq innermost, so a ring joins neighbouring ranks. Every rank
    of the default group must call it, as `dist.new_group` requires."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if seq * data > world:
        raise ValueError(f"seq {seq} x data {data} needs {seq * data} ranks, have {world}")
    seq_group = data_group = None
    for d in range(data):
        ranks = list(range(d * seq, (d + 1) * seq))
        g = dist.new_group(ranks)
        if rank in ranks:
            seq_group = g
    for i in range(seq):
        ranks = [d * seq + i for d in range(data)]
        g = dist.new_group(ranks)
        if rank in ranks:
            data_group = g
    return seq_group, data_group


def sequence_parallel_stack(blocks, x, c, ring):
    """Run the DiT blocks with the tokens sharded around `ring`.

    blocks: the model's `DiTBlock`s, run with ring attention.
    x: (B, N, D) tokens, N divisible by the ring size; c: (B, D). Under a
    process ring every rank passes the whole x and c.
    Returns (B, N, D), equal to applying the blocks unsharded.
    """
    xs, cs = ring.shard(x), ring.expand(c)
    for block in blocks:
        xs = block(xs, cs, ring)
    return ring.unshard(xs)


def dit_sequence_parallel_forward(model, x, t, y, ring):
    """The DiT forward with its tokens sharded around `ring`.

    The contract of `model(x, t, y)` on the inference path, with no label
    dropout (`fast_dit_tpu/parallel/sequence.py:74-119`): `model(x, t, y,
    ring=ring)`. The port's DiT is dense and exact (no quant, ToMe or MoE),
    so every model qualifies, with or without remat. The final layer is per
    token and runs on the shards; the shards are gathered before
    `unpatchify`. Under a process ring every rank passes the whole x, t and
    y and gets the whole output; its parameter gradients are the partials of
    its shard, which the caller sums over the group.
    """
    return model(x, t, y, ring=ring)
