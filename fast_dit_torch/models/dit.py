"""The DiT backbone (counterpart of `fast_dit_tpu/models/dit.py`).

patchify -> frozen 2D sin-cos pos-embed -> depth x adaLN-Zero blocks ->
FinalLayer -> unpatchify, with c = t_emb + y_emb, learn_sigma channel
doubling, the CFG doubled-batch `forward_with_cfg` with its 3-channel
guidance quirk, and the registry: the 12 dense configs and the three
DiT-MoE-*-8E2A configs (8 experts, 2 active per token).

JAX's block options (`:111-124`): `quant="w8a8"` (int8 block projections,
inference only), `tome_ratio`/`tome_mlp` (token merging, inference only;
the merge count `tome_r` is computed once from the number of patches) and
`moe_experts`/`moe_top_k`/`moe_capacity` (routed expert MLPs). A MoE
model's forward gives its per-layer aux values with `want_aux=True`
(`models/moe.py`), where JAX sows them into a "losses" collection during
training; the cached and the sequence-parallel paths have none, as in JAX,
and the sequence-parallel path refuses all three options, as JAX does.

Blocks are an `nn.ModuleList` (`blocks.{i}.*`, the reference names), not a
scan. `pos_embed` is a frozen fp32 (1, N, D) buffer: an entry of the state
dict, as the reference expects, but not a parameter, so it stays fp32 when
training stores the parameters in bf16. Parameters are fp32 unless the
trainer casts them; `dtype` is the compute dtype.

`remat=True` checkpoints every block (`torch.utils.checkpoint`,
non-reentrant) under one of JAX's policies (`fast_dit_tpu/models/dit.py:133-146`):
"nothing" recomputes the whole block, "attn" and "attn_mlp" also keep the
branch outputs `attn_out` (and `mlp_out`), as regions of their own
(`DiTBlock.remat_forward`). Every policy gives the gradients of no remat
bit for bit.

The layer cache of the cached samplers (`:99-100,212-226`): `want_cache=True`
also returns (attn_outs, mlp_outs), each stacked on a leading layer axis;
`cache=` replays them through `DiTBlock.cached_step`, with fresh adaLN
gates and no attention, so a cached call launches no kernel.

The constructor builds the model on `device` ("cuda" unless the caller asks
for the CPU) and initialises it from `seed` with a CPU `torch.Generator`,
so the same seed gives the same weights on every device.
"""

from __future__ import annotations

import functools
import math

import torch
from torch import nn

from ..ops.tome import tome_merge_count
from ..utils.device import resolve_device
from .layers import DiTBlock, FinalLayer, LabelEmbedder, PatchEmbed, TimestepEmbedder
from .moe import AUX_NAMES, MoeMlp
from .pos_embed import get_2d_sincos_pos_embed

__all__ = ["DiT", "DiT_models", "dit_config", "dit_moe_config", "REMAT_POLICIES"]

# what the backward keeps instead of recomputing, with remat on
REMAT_POLICIES = ("nothing", "attn", "attn_mlp")


def _xavier_uniform_(w: torch.Tensor, g: torch.Generator) -> None:
    fan_out, fan_in = w.shape[0], w[0].numel()
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        w.uniform_(-bound, bound, generator=g)


class DiT(nn.Module):
    """Diffusion Transformer."""

    def __init__(self, input_size=32, patch_size=2, in_channels=4, hidden_size=1152,
                 depth=28, num_heads=16, mlp_ratio=4.0, class_dropout_prob=0.1,
                 num_classes=1000, learn_sigma=True, dtype=torch.float32,
                 attn_backend="auto", remat=False, remat_policy="nothing", quant=None,
                 tome_ratio=0.0, tome_mlp=False, moe_experts=0, moe_top_k=2,
                 moe_capacity=1.25, device="cuda", seed=0):
        super().__init__()
        device = resolve_device(device)
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat policy {remat_policy!r}; the policies are "
                             f"{REMAT_POLICIES}")
        self.input_size = input_size
        self.patch_size = patch_size
        self.in_channels = in_channels
        self.out_channels = in_channels * 2 if learn_sigma else in_channels
        self.hidden_size = hidden_size
        self.depth = depth
        self.num_heads = num_heads
        self.mlp_ratio = mlp_ratio
        self.num_classes = num_classes
        self.dtype = dtype
        self.remat = remat
        self.remat_policy = remat_policy
        self.quant = quant
        self.tome_ratio = tome_ratio
        self.tome_mlp = tome_mlp
        self.moe_experts = moe_experts
        grid = input_size // patch_size
        self.tome_r = tome_merge_count(grid * grid, tome_ratio) if tome_ratio > 0 else 0

        self.x_embedder = PatchEmbed(patch_size, in_channels, hidden_size, dtype=dtype)
        self.t_embedder = TimestepEmbedder(hidden_size, dtype=dtype)
        self.y_embedder = LabelEmbedder(num_classes, hidden_size, class_dropout_prob)
        pos = get_2d_sincos_pos_embed(hidden_size, grid).astype("float32")[None]
        self.register_buffer("pos_embed", torch.from_numpy(pos))
        self.blocks = nn.ModuleList([
            DiTBlock(hidden_size, num_heads, mlp_ratio=mlp_ratio, dtype=dtype,
                     attn_backend=attn_backend, quant=quant, tome_r=self.tome_r,
                     tome_mlp=tome_mlp, moe_experts=moe_experts, moe_top_k=moe_top_k,
                     moe_capacity=moe_capacity)
            for _ in range(depth)])
        self.final_layer = FinalLayer(hidden_size, patch_size, self.out_channels, dtype=dtype)
        self.initialize_weights(seed)
        self.to(device)

    def initialize_weights(self, seed: int) -> None:
        """The reference init: xavier-uniform linears and patch embedding,
        N(0, 0.02) label table and timestep MLP, zeroed adaLN and head; a
        MoE MLP's experts each xavier-uniform on their own fans, as in JAX."""
        g = torch.Generator().manual_seed(seed)
        routers = {id(m.router) for m in self.modules() if isinstance(m, MoeMlp)}
        for m in self.modules():
            if isinstance(m, MoeMlp):
                m.init_weights(g)
            elif isinstance(m, nn.Linear) and id(m) not in routers:
                _xavier_uniform_(m.weight, g)
                nn.init.zeros_(m.bias)
        _xavier_uniform_(self.x_embedder.proj.weight, g)
        nn.init.zeros_(self.x_embedder.proj.bias)
        with torch.no_grad():
            self.y_embedder.embedding_table.weight.normal_(0.0, 0.02, generator=g)
            self.t_embedder.mlp[0].weight.normal_(0.0, 0.02, generator=g)
            self.t_embedder.mlp[2].weight.normal_(0.0, 0.02, generator=g)
        for block in self.blocks:
            nn.init.zeros_(block.adaLN_modulation[-1].weight)
            nn.init.zeros_(block.adaLN_modulation[-1].bias)
        for lin in (self.final_layer.adaLN_modulation[-1], self.final_layer.linear):
            nn.init.zeros_(lin.weight)
            nn.init.zeros_(lin.bias)

    def unpatchify(self, x):
        """(B, N, p*p*C_out) -> (B, C_out, H, W)."""
        c, p = self.out_channels, self.patch_size
        h = w = int(x.shape[1] ** 0.5)
        assert h * w == x.shape[1]
        x = x.reshape(x.shape[0], h, w, p, p, c)
        x = torch.einsum("nhwpqc->nchpwq", x)
        return x.reshape(x.shape[0], c, h * p, w * p)

    def forward(self, x, t, y, *, train=False, force_drop_ids=None, generator=None, ring=None,
                cache=None, want_cache=False, want_aux=False):
        """x: (B, C, H, W), t: (B,) int timesteps, y: (B,) int labels ->
        (B, out_channels, H, W) fp32. With `train`, labels are dropped to
        the null class with probability class_dropout_prob, drawn from
        `generator`. With `ring` (`parallel/sequence.py`), the blocks and the
        final layer run on the token shards of the ring, with ring attention,
        and the shards are gathered before `unpatchify`. With `want_cache`,
        returns (out, (attn_outs, mlp_outs)), each (depth, B, N, D); with
        `cache=(attn_outs, mlp_outs)` the blocks replay it. With `want_aux`,
        returns (out, aux): for a MoE model {name: (depth,) fp32} for each of
        `moe.AUX_NAMES`, from this forward's graph; None for a dense one."""
        if train and self.quant:
            raise ValueError("int8 quantization is inference-only")
        if train and self.tome_ratio > 0:
            raise ValueError("token merging is inference-only")
        if ring is not None and (self.quant or self.tome_ratio > 0 or self.moe_experts):
            raise ValueError(
                "sequence parallelism is exact-only dense-DiT: quant/tome/moe "
                f"(quant={self.quant!r}, tome_ratio={self.tome_ratio}, "
                f"moe_experts={self.moe_experts}) are not supported by the token-sharded "
                "block stack")
        if want_aux and (cache is not None or want_cache):
            raise ValueError("the layer cache carries no MoE aux values")
        x = self.x_embedder(x) + self.pos_embed.to(self.dtype)
        t_emb = self.t_embedder(t)
        y_emb = self.y_embedder(y, train, force_drop_ids, generator)
        c = t_emb + y_emb.to(t_emb.dtype)
        if ring is not None:
            if cache is not None or want_cache:
                raise ValueError("the layer cache runs on unsharded tokens")
            x, c = ring.shard(x), ring.expand(c)
        remat = self.remat and torch.is_grad_enabled()
        new_cache = None
        if cache is not None:
            attn_outs, mlp_outs = cache
            for block, a, m in zip(self.blocks, attn_outs, mlp_outs):
                x = block.cached_step(x, c, a, m)
        elif want_cache:
            branches = []
            for block in self.blocks:
                x, outs = block.full_step(x, c)
                branches.append(outs)
            new_cache = tuple(torch.stack(outs) for outs in zip(*branches))
        else:
            auxes = []
            for block in self.blocks:
                x, aux = (block.remat_forward(x, c, ring, self.remat_policy) if remat
                          else block.forward_aux(x, c, ring))
                auxes.append(aux)
        x = self.final_layer(x, c)
        if ring is not None:
            x = ring.unshard(x)
        out = self.unpatchify(x).float()
        if want_aux:
            aux = None
            if self.moe_experts:
                aux = dict(zip(AUX_NAMES, torch.stack(auxes).unbind(1)))
            return out, aux
        return (out, new_cache) if want_cache else out

    def forward_with_cfg(self, x, t, y, cfg_scale, guidance_channels: int = 3, *, cache=None,
                         want_cache=False):
        """Classifier-free-guidance doubled-batch forward. The batch is
        [cond ; uncond]; only the first half of x is used (mirrored), and
        guidance applies to the first `guidance_channels` channels only (3,
        the reference's quirk; pass `in_channels` for standard CFG).
        `cache` and `want_cache` are `forward`'s."""
        half = x[: x.shape[0] // 2]
        model_out = self(torch.cat([half, half], dim=0), t, y, cache=cache,
                         want_cache=want_cache)
        if want_cache:
            model_out, new_cache = model_out
        eps, rest = model_out[:, :guidance_channels], model_out[:, guidance_channels:]
        cond_eps, uncond_eps = eps.chunk(2, dim=0)
        half_eps = uncond_eps + cfg_scale * (cond_eps - uncond_eps)
        eps = torch.cat([half_eps, half_eps], dim=0)
        out = torch.cat([eps, rest], dim=1)
        return (out, new_cache) if want_cache else out


def dit_config(depth, hidden_size, patch_size, num_heads):
    """Constructor partial for a named config."""
    return functools.partial(DiT, depth=depth, hidden_size=hidden_size,
                             patch_size=patch_size, num_heads=num_heads)


def dit_moe_config(depth, hidden_size, patch_size, num_heads, experts, top_k):
    """A MoE config ('<E>E<A>A': E experts, A active per token)."""
    return functools.partial(DiT, depth=depth, hidden_size=hidden_size,
                             patch_size=patch_size, num_heads=num_heads,
                             moe_experts=experts, moe_top_k=top_k)


DiT_models = {
    "DiT-XL/2": dit_config(28, 1152, 2, 16),
    "DiT-XL/4": dit_config(28, 1152, 4, 16),
    "DiT-XL/8": dit_config(28, 1152, 8, 16),
    "DiT-L/2": dit_config(24, 1024, 2, 16),
    "DiT-L/4": dit_config(24, 1024, 4, 16),
    "DiT-L/8": dit_config(24, 1024, 8, 16),
    "DiT-B/2": dit_config(12, 768, 2, 12),
    "DiT-B/4": dit_config(12, 768, 4, 12),
    "DiT-B/8": dit_config(12, 768, 8, 12),
    "DiT-S/2": dit_config(12, 384, 2, 6),
    "DiT-S/4": dit_config(12, 384, 4, 6),
    "DiT-S/8": dit_config(12, 384, 8, 6),
    "DiT-MoE-S/2-8E2A": dit_moe_config(12, 384, 2, 6, 8, 2),
    "DiT-MoE-B/2-8E2A": dit_moe_config(12, 768, 2, 12, 8, 2),
    "DiT-MoE-XL/2-8E2A": dit_moe_config(28, 1152, 2, 16, 8, 2),
}
