"""Pipeline parallelism over the DiT block stack (GPipe).

Counterpart of `fast_dit_tpu/parallel/pipeline.py`. The depth blocks split
into P stages of depth / P contiguous blocks; the batch splits into M
microbatches of contiguous rows (`:62-63`); stage s holds microbatch t - s
at tick t of M + P - 1 ticks. The stages live in a stage holder:

- `LocalStages(n)`: all n stages in one process, the counterpart of the JAX
  tests' virtual-device mesh. It runs the ticks in order; the gradient is
  autograd's through the same ops.
- `ProcessGroupStages(group)`: rank s of a `torch.distributed` group is
  stage s and reads only its own blocks, `blocks[s L / P:(s + 1) L / P]`,
  so the others may be left out of its memory (`keep_own_blocks`). Activations go from stage s
  to s + 1 point to point; the last stage broadcasts the finished tokens to
  every rank (JAX `psum`s a tensor that is zero but on the last stage,
  `:98-103`: the same value).

JAX computes every tick on every stage and masks the bubble slots
(`:78-95`). The schedule is static, so here the host decides which slots
are live and a bubble runs nothing: a pipelined forward launches each
block's attention exactly M times, and its backward M times.

Gradients. JAX's pipeline is one SPMD program whose `ppermute` transposes
to the reverse permutation. Autograd through point-to-point calls would
hang as soon as one rank's loss does not reach its sends, so a process
stage runs its whole stack under one autograd function (`_StageStack`):
its forward runs the microbatches and keeps each one's graph, its backward
replays them in reverse order, receiving the next stage's cotangent,
running this stage's blocks' backward (`torch.autograd.grad`) and sending
the input's cotangent on. Every rank must back-propagate the same loss of
the replicated output: the last stage takes its own cotangent. The
gradient of the stack's input is broadcast from stage 0 and that of the
conditioning summed over the stages, so the replicated parameters (the
embedders and the final layer) come out whole and equal on every rank;
each rank's block parameters get their gradients on their own rank only.

Transport: on a gloo group, a CUDA tensor's point-to-point hand-off is
copied through a host buffer, since gloo's send and recv fail on CUDA
tensors (`collectives.through_host`); broadcast and all-reduce take CUDA
tensors as they are.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .collectives import all_reduce, broadcast, sync_exempt, through_host
from .sequence import create_seq_groups

__all__ = ["LocalStages", "ProcessGroupStages", "create_pipeline_groups", "stage_slice",
           "keep_own_blocks", "pipeline_apply", "dit_pipeline_forward"]


class LocalStages:
    """n pipeline stages in one process."""

    def __init__(self, n: int):
        if n < 1:
            raise ValueError(f"a pipeline has at least one stage, got {n}")
        self.size = n


class ProcessGroupStages:
    """Rank s of a `torch.distributed` group: pipeline stage s."""

    def __init__(self, group=None):
        self.group = dist.group.WORLD if group is None else group
        self.size = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)

    def _peer(self, stage: int) -> int:
        return dist.get_global_rank(self.group, stage)

    def send(self, t: torch.Tensor, stage: int):
        """Start sending `t` to `stage`; returns a handle to `wait` on (it
        keeps the tensor sent alive)."""
        t = t.detach().contiguous()
        with sync_exempt(t, self.group):
            sent = t.cpu() if through_host(t, self.group) else t
            return t, sent, dist.isend(sent, self._peer(stage), group=self.group)

    def wait(self, handles) -> None:
        for t, _, work in handles:
            with sync_exempt(t, self.group):
                work.wait()

    def recv(self, like: torch.Tensor, stage: int) -> torch.Tensor:
        """A tensor of `like`'s shape, dtype and device from `stage`."""
        host = through_host(like, self.group)
        buf = torch.empty(like.shape, dtype=like.dtype, device="cpu" if host else like.device)
        with sync_exempt(like, self.group):
            dist.recv(buf, self._peer(stage), group=self.group)
            return buf.to(like.device) if host else buf

    def broadcast(self, t: torch.Tensor, stage: int) -> torch.Tensor:
        return broadcast(t, stage, self.group)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        return all_reduce(t, self.group)


def create_pipeline_groups(pipe: int, data: int = 1):
    """(pipe group, data group) of this rank, the counterpart of
    `create_pipeline_mesh` (:32): ranks [d * pipe, (d + 1) * pipe) form the
    d-th pipeline, stages innermost, so neighbouring stages are neighbouring
    ranks; the data group joins the same stage of every pipeline. Every
    rank of the default group must call it, as `dist.new_group` requires."""
    return create_seq_groups(pipe, data)


def stage_slice(depth: int, stages, stage: int) -> slice:
    """The blocks of `stage`."""
    per = depth // stages.size
    return slice(stage * per, (stage + 1) * per)


def keep_own_blocks(model, stages) -> None:
    """Under process stages, replace the other stages' blocks of `model` by
    `nn.Identity` (which takes no conditioning, so a stage that called one
    would fail), so that a rank holds only its depth / P blocks; nothing
    under `LocalStages`."""
    if isinstance(stages, LocalStages):
        return
    own = range(model.depth)[stage_slice(model.depth, stages, stages.rank)]
    for i in range(model.depth):
        if i not in own:
            model.blocks[i] = torch.nn.Identity()


def _check(depth: int, batch: int, stages, num_microbatches: int) -> None:
    if depth % stages.size:
        raise ValueError(f"depth {depth} does not split into {stages.size} stages")
    if num_microbatches < 1 or batch % num_microbatches:
        raise ValueError(f"batch {batch} does not split into {num_microbatches} microbatches")


def _run(blocks, x, c):
    for block in blocks:
        x = block(x, c)
    return x


def _local_ticks(blocks, x, c, stages, M):
    """GPipe's ticks in one process: stage s runs microbatch t - s at tick
    t where that slot is live, and nothing in a bubble."""
    xs, cs = list(x.chunk(M)), c.chunk(M)
    P = stages.size
    for tick in range(M + P - 1):
        for s in range(P):
            m = tick - s
            if 0 <= m < M:
                xs[m] = _run(blocks[stage_slice(len(blocks), stages, s)], xs[m], cs[m])
    return torch.cat(xs)


def _stage_forward(blocks, x, c, stages, M, keep):
    """This rank's stage over the M microbatches, then the last stage's
    tokens broadcast to every rank. With `keep`, each microbatch's graph is
    kept for `_StageStack.backward`: (input, conditioning, output)."""
    s, P = stages.rank, stages.size
    xs, cs = x.chunk(M), c.chunk(M)
    saved, outs, sends = [], [], []
    for m in range(M):
        inp = xs[m] if s == 0 else stages.recv(xs[m], s - 1)
        if keep:
            inp, cm = inp.detach().requires_grad_(), cs[m].detach().requires_grad_()
            with torch.enable_grad():
                out = _run(blocks, inp, cm)
            saved.append((inp, cm, out))
        else:
            out = _run(blocks, inp, cs[m])
        if s < P - 1:
            sends.append(stages.send(out, s + 1))
        else:
            outs.append(out.detach())
    stages.wait(sends)
    full = torch.cat(outs) if s == P - 1 else torch.empty_like(x)
    return stages.broadcast(full, P - 1), saved


class _StageStack(torch.autograd.Function):
    """A process stage's blocks over every microbatch, forward and reverse
    (see the module docstring)."""

    @staticmethod
    def forward(ctx, x, c, stages, blocks, M, *params):
        out, ctx.saved = _stage_forward(blocks, x, c, stages, M, keep=True)
        ctx.stages, ctx.params, ctx.x = stages, params, x
        return out

    @staticmethod
    def backward(ctx, grad_out):
        stages, params, saved = ctx.stages, ctx.params, ctx.saved
        x = ctx.x
        s, P = stages.rank, stages.size
        g_mbs = grad_out.chunk(len(saved))
        dparams = [None] * len(params)
        dxs, dcs, sends = [None] * len(saved), [None] * len(saved), []
        for m in reversed(range(len(saved))):
            inp, cm, out = saved[m]
            g = g_mbs[m].to(out.dtype) if s == P - 1 else stages.recv(out, s + 1)
            d_inp, d_cm, *dps = torch.autograd.grad(out, (inp, cm, *params), g,
                                                    allow_unused=True)
            saved[m] = None  # this microbatch's graph is spent
            dcs[m] = torch.zeros_like(cm) if d_cm is None else d_cm
            for i, d in enumerate(dps):
                if d is not None:
                    dparams[i] = d if dparams[i] is None else dparams[i] + d
            if s > 0:
                sends.append(stages.send(d_inp, s - 1))
            else:
                dxs[m] = d_inp
        stages.wait(sends)
        dx = torch.cat(dxs) if s == 0 else torch.empty_like(x)
        ctx.saved = ctx.x = None
        return (stages.broadcast(dx, 0), stages.all_reduce(torch.cat(dcs)), None, None, None,
                *dparams)


def pipeline_apply(blocks, x, c, stages, num_microbatches: int):
    """Run the block sequence as a GPipe pipeline over `stages`.

    blocks: modules `block(x, c) -> x` of unchanged shape and dtype,
        len(blocks) divisible by the stage count.
    x: (B, N, D) tokens, B divisible by `num_microbatches`; c: (B, D). Under
        process stages every rank passes the whole x and c.
    Returns (B, N, D), equal to applying the blocks in sequence; under
    process stages every rank gets it whole.
    """
    M = num_microbatches
    _check(len(blocks), x.shape[0], stages, M)
    if isinstance(stages, LocalStages):
        return _local_ticks(blocks, x, c, stages, M)
    own = blocks[stage_slice(len(blocks), stages, stages.rank)]
    params = [p for b in own for p in b.parameters() if p.requires_grad]
    if torch.is_grad_enabled() and (x.requires_grad or c.requires_grad or params):
        return _StageStack.apply(x, c, stages, own, M, *params)
    return _stage_forward(own, x, c, stages, M, keep=False)[0]


def refuse_options(model, what: str) -> None:
    """JAX's refusal (`:141-146`): the stage-split stacks are dense DiT only."""
    if model.quant or model.tome_ratio > 0 or model.moe_experts:
        raise ValueError(
            f"{what} is exact-only dense-DiT: quant/tome/moe (quant={model.quant!r}, "
            f"tome_ratio={model.tome_ratio}, moe_experts={model.moe_experts}) are not "
            "supported by the stage-sharded block stack")


def embed(model, x, t, y):
    """(tokens, c) of `model`'s inference forward, no label dropout: the
    embedders, which run replicated on every stage."""
    tokens = model.x_embedder(x) + model.pos_embed.to(model.dtype)
    t_emb = model.t_embedder(t)
    return tokens, t_emb + model.y_embedder(y).to(t_emb.dtype)


def dit_pipeline_forward(model, x, t, y, stages, num_microbatches: int):
    """The DiT forward with its blocks pipelined over `stages`.

    The contract of `model(x, t, y)` on the inference path, with no label
    dropout (`fast_dit_tpu/parallel/pipeline.py:115-162`): the embedders and
    the final layer run replicated, the depth blocks stage-split, as plain
    blocks (the model's remat setting does not apply, as in JAX). Raises for
    a quantised, token-merging or MoE model, for depth not divisible by the
    stage count and for a batch not divisible by `num_microbatches`.
    Differentiable; under process stages every rank passes the whole x, t
    and y and gets the whole (B, C_out, H, W) fp32 output.
    """
    refuse_options(model, "pipeline parallelism")
    tokens, c = embed(model, x, t, y)
    tokens = pipeline_apply(model.blocks, tokens, c, stages, num_microbatches)
    return model.unpatchify(model.final_layer(tokens, c)).float()
