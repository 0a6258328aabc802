"""PipeFusion: patch-level pipeline parallelism for DiT inference.

Counterpart of `fast_dit_tpu/parallel/pipefusion.py` (arXiv:2405.14430).
The token sequence splits into M chunks of N / M tokens that pass through
the stages of `parallel/pipeline.py` (`LocalStages`, `ProcessGroupStages`)
one after another. Each layer keeps a K/V cache of the whole sequence, and
a chunk attends to it with its own K/V fresh.

The cache follows JAX's code as it runs, not its docstring: every tick's
layer scan reads the step's input cache (`kv_local`, `:170`), not the cache
carried through the ticks. So within a step, chunk i attends to its own
fresh K/V and to the step's input K/V for every other chunk, and the cache
returned holds the input cache with only the last chunk's K/V fresh (the
last live tick of every stage writes it). Here a chunk but the last
attends to a copy of the layer's cache with its K/V spliced in, and the
last writes its K/V into the cache in place.

Semantics do not depend on the schedule, so `LocalStages` runs the chunks
in order through all layers; a process stage runs its layers on each chunk
as it arrives from the stage before, keeps its layers' cache on its own
rank (`init_kv_cache(..., stages=)` makes its (depth / P, ...) slice), and
the last stage broadcasts the finished tokens. No bubble touches the
cache, as JAX's masked bubble ticks leave it (`:176-177`).

`num_chunks=1` is exact: every position's K/V is rewritten before it is
read. With more chunks the result is approximate, so
`pipefusion_sample_loop` runs `warmup` exact steps first. Like the FORA
layer cache this is an opt-in approximate path.

The chunk's attention (n queries against N keys and values) is XLA's
`jax.nn.dot_product_attention` in JAX, not a Pallas kernel, and stock
`F.scaled_dot_product_attention` here; kernel 1's packed-qkv contract needs
equal lengths.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..diffusion import sampling
from ..diffusion.schedule import DiffusionSchedule
from .pipeline import LocalStages, embed, refuse_options, stage_slice

__all__ = ["init_kv_cache", "pipefusion_forward", "pipefusion_sample_loop"]


def init_kv_cache(model, batch: int, dtype=None, stages=None) -> torch.Tensor:
    """A zero K/V cache (depth, 2, B, N, H, hd) in the model's dtype on its
    device; under process stages this rank's (depth / P, 2, B, N, H, hd).
    Built anew for every sampling run; zeros are read only by a chunked
    first step, which `pipefusion_sample_loop` never takes."""
    depth = model.depth
    if stages is not None and not isinstance(stages, LocalStages):
        depth //= stages.size
    H, N = model.num_heads, model.pos_embed.shape[1]
    return torch.zeros((depth, 2, batch, N, H, model.hidden_size // H),
                       dtype=model.dtype if dtype is None else dtype,
                       device=model.pos_embed.device)


def _block_chunk_step(block, x, c, kv_l, start: int, write: bool) -> torch.Tensor:
    """One DiT block on a token chunk x (B, n, D), the ops of
    `DiTBlock._step` in its order: adaLN, LayerNorm, qkv, attention of the
    chunk's queries against `kv_l` (2, B, N, H, hd) with the chunk's K/V at
    token `start`, proj, the MLP. With `write` the chunk's K/V go into
    `kv_l` in place; else into a copy that is dropped (`:95-98`)."""
    from ..models.layers import _layer_norm, modulate  # noqa: PLC0415 (models import parallel)

    shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = block._modulation(c)
    h = modulate(_layer_norm(x, block.dtype), shift_msa, scale_msa)
    B, n, D = h.shape
    H = kv_l.shape[3]
    qkv = block.attn.qkv(h).view(B, n, 3, H, D // H)  # columns in (3, H, hd) order
    fresh = qkv[:, :, 1:].permute(2, 0, 1, 3, 4).to(kv_l.dtype)
    if write:
        kv_l[:, :, start:start + n].copy_(fresh)
    else:
        kv_l = torch.cat([kv_l[:, :, :start], fresh, kv_l[:, :, start + n:]], dim=2)
    k, v = (kv_l[i].to(qkv.dtype).transpose(1, 2) for i in range(2))
    attn = F.scaled_dot_product_attention(qkv[:, :, 0].transpose(1, 2), k, v)
    attn_out = block.attn.proj(attn.transpose(1, 2).reshape(B, n, D))
    x, mlp_out, _ = block._mlp_branch(x, gate_msa, attn_out, shift_mlp, scale_mlp)
    return x + gate_mlp[:, None, :] * mlp_out


def _chunk_through(blocks, kv, xc, c, i: int, n: int, M: int) -> torch.Tensor:
    for block, kv_l in zip(blocks, kv):
        xc = _block_chunk_step(block, xc, c, kv_l, i * n, write=i == M - 1)
    return xc


@torch.no_grad()
def pipefusion_forward(model, x, t, y, kv, stages, num_chunks: int):
    """The DiT forward with patch chunks pipelined over `stages`.

    The contract of `model(x, t, y)` on the inference path, with no label
    dropout, plus the K/V cache: pass the previous step's `kv` (or
    `init_kv_cache(...)`), get `(out, kv)` back, the cache updated in place.
    `num_chunks=1` is exact; with more, each chunk attends to the input
    cache's K/V for the other chunks. JAX's asserts (`:121-124`): mlp_ratio
    4 and no MoE; quantised and token-merging models are refused too, since
    the chunk step rebuilds the plain dense block. Raises for depth or
    tokens that do not split. Under process stages every rank passes the
    whole x, t and y and its own cache, and gets the whole output.
    Inference only: no graph is kept.
    """
    if model.mlp_ratio != 4.0:
        raise ValueError("pipefusion supports mlp_ratio=4 configs")
    refuse_options(model, "pipefusion")
    depth, P, M = model.depth, stages.size, num_chunks
    if depth % P:
        raise ValueError(f"depth {depth} does not split into {P} stages")
    tokens, c = embed(model, x, t, y)
    B, N, D = tokens.shape
    if M < 1 or N % M:
        raise ValueError(f"{N} tokens do not split into {M} chunks")
    n = N // M
    if isinstance(stages, LocalStages):
        tokens = torch.cat([_chunk_through(model.blocks, kv, tokens[:, i * n:(i + 1) * n], c,
                                           i, n, M) for i in range(M)], dim=1)
    else:
        s = stages.rank
        blocks = model.blocks[stage_slice(depth, stages, s)]
        chunks, sends = [], []
        for i in range(M):
            xc = tokens[:, i * n:(i + 1) * n]
            if s > 0:
                xc = stages.recv(xc, s - 1)
            xc = _chunk_through(blocks, kv, xc, c, i, n, M)
            if s < P - 1:
                sends.append(stages.send(xc, s + 1))
            else:
                chunks.append(xc)
        stages.wait(sends)
        tokens = stages.broadcast(torch.cat(chunks, dim=1) if s == P - 1
                                  else torch.empty_like(tokens), P - 1)
    return model.unpatchify(model.final_layer(tokens, c)).float(), kv


def pipefusion_sample_loop(model, shape, sched: DiffusionSchedule, y, stages, num_chunks: int,
                           *, warmup: int = 1, kind: str = "ddim", generator=None, noise=None,
                           step_noise=None, eta: float = 0.0, clip_denoised: bool = True,
                           cfg_scale=None, guidance_channels: int = 3):
    """Reverse-process sampling with the patch-pipelined forward
    (`fast_dit_tpu/parallel/pipefusion.py:203-292`).

    `kind` "p" (DDPM) or "ddim". The loop is the port's `_loop`
    (`diffusion/sampling.py`): t from the schedule's host map, x_T from
    `noise` or `generator`, the k-th step's Gaussian from `step_noise[k]` or
    `generator`. JAX draws x_T and each step's noise from `fold_in` keys of
    one `rng` (`:243-249`); the port draws them in turn from one seeded
    `torch.Generator`, as `sample_ddp` does, so equal seeds do not give
    JAX's draws: pass JAX's as `noise` and `step_noise` to reproduce its
    chain. The first `warmup` steps (at least 1, at most T) run exact (one
    chunk) to fill the cache, the rest with `num_chunks` chunks.

    `cfg_scale` (not None or 1) runs classifier-free guidance as
    `forward_with_cfg` does: the pipelined forward on [x ; x] with labels
    [y ; null] (null = `model.num_classes`), the cache covering both halves,
    the guided eps on the first `guidance_channels` channels driving a
    single-width update. `y` holds the B conditional labels.
    """
    if kind not in ("p", "ddim"):
        raise ValueError(f"kind must be 'p' or 'ddim', got {kind!r}")
    T = sched.num_timesteps
    warmup = min(max(warmup, 1), T)  # step 0 must be exact (cold cache)
    B = (noise.shape if noise is not None else shape)[0]
    y = torch.as_tensor(y, device=model.pos_embed.device)
    use_cfg = cfg_scale is not None and cfg_scale != 1.0
    if use_cfg:
        y = torch.cat([y, torch.full_like(y, model.num_classes)])
    kv = init_kv_cache(model, y.shape[0], stages=stages)
    steps = 0

    def model_fn(x, t):
        nonlocal steps
        chunks = 1 if steps < warmup else num_chunks
        steps += 1
        if not use_cfg:
            return pipefusion_forward(model, x, t, y, kv, stages, chunks)[0]
        out = pipefusion_forward(model, torch.cat([x, x]), torch.cat([t, t]), y, kv, stages,
                                 chunks)[0]
        cond_eps, uncond_eps = out[:, :guidance_channels].chunk(2)
        half_eps = uncond_eps + cfg_scale * (cond_eps - uncond_eps)
        return torch.cat([half_eps, out[:B, guidance_channels:]], dim=1)

    if kind == "p":
        return sampling.p_sample_loop(model_fn, shape, sched, generator=generator, noise=noise,
                                      step_noise=step_noise, clip_denoised=clip_denoised)
    return sampling.ddim_sample_loop(model_fn, shape, sched, generator=generator, noise=noise,
                                     step_noise=step_noise, clip_denoised=clip_denoised, eta=eta)
