"""DINO-feature cross-attention conditioning for DiT, the NVS model
(counterpart of `fast_dit_tpu/nvs/conditioning.py`).

`CrossAttention` (:39) takes queries from the image tokens and keys and
values from the DINO tokens through `ops.attention.dot_product_attention`:
on the card, where both sides have the same number of tokens (256 image
tokens at 256²/p2 against DINOv2 ViT-B/14's 16x16 grid at 224²), the
packed attention kernels run, forward and backward; unequal lengths need
attn_backend="einsum" there. `DiTCrossBlock` (:65) gates self-attention,
cross-attention and the MLP with a 9-way adaLN chunk; `DiTNVS` (:106)
embeds the (B, dino_dim, gh, gw) feature map with a patch-1 `PatchEmbed`
(`dino_embedder`) and runs the cross branch at the static set
`cross_layers`.

JAX computes the cross branch in every layer and multiplies it by 0
outside `cross_layers` (:97), since `nn.scan` needs one body for all
layers; here each block knows whether it is a cross layer and runs the
branch only there. The other layers keep their `cross_attn.*` parameters
(JAX's stacked leaves hold them) and their adaLN's cross columns, whose
gradient is then None or zero where JAX's is exactly zero; the trainer
fills a None gradient with zeros (`train/train_lib.py`), so AdamW's weight
decay moves those leaves as JAX's does. The forward output is fp32 (:200).

Parameter names: `blocks.{i}.cross_attn.{to_q,to_k,to_v,proj}` as `Linear`s,
`blocks.{i}.adaLN_modulation.1` of width 9D, `dino_embedder.proj` a
(D, dino_dim, 1, 1) weight; the rest are the DiT's. The constructor builds
on `device` ("cuda" unless the caller asks for the CPU) and initialises
from `seed` as the DiT does.
"""

from __future__ import annotations

import torch
from torch import nn

from ..models.dit import DiT, _xavier_uniform_
from ..models.layers import (Attention, FinalLayer, LabelEmbedder, Linear, Mlp, PatchEmbed,
                             TimestepEmbedder, _layer_norm, modulate)
from ..models.pos_embed import get_2d_sincos_pos_embed
from ..ops.attention import dot_product_attention, resolve_backend
from ..utils.device import resolve_device

__all__ = ["CrossAttention", "DiTCrossBlock", "DiTNVS"]


class CrossAttention(nn.Module):
    """Queries from image tokens, keys and values from context tokens."""

    def __init__(self, hidden_size, num_heads, dtype=torch.float32, attn_backend="auto"):
        super().__init__()
        assert hidden_size % num_heads == 0
        self.num_heads = num_heads
        self.attn_backend = resolve_backend(attn_backend)
        self.to_q = Linear(hidden_size, hidden_size, dtype=dtype)
        self.to_k = Linear(hidden_size, hidden_size, dtype=dtype)
        self.to_v = Linear(hidden_size, hidden_size, dtype=dtype)
        self.proj = Linear(hidden_size, hidden_size, dtype=dtype)

    def forward(self, x, context):
        out = dot_product_attention(self.to_q(x), self.to_k(context), self.to_v(context),
                                    self.num_heads, backend=self.attn_backend)
        return self.proj(out)


class DiTCrossBlock(nn.Module):
    """adaLN-Zero block with a gated cross-attention branch: shift, scale
    and gate for self-attention, cross-attention and the MLP. With
    `use_cross` False the branch does not run."""

    def __init__(self, hidden_size, num_heads, mlp_ratio=4.0, dtype=torch.float32,
                 attn_backend="auto", use_cross=True):
        super().__init__()
        self.dtype = dtype
        self.use_cross = use_cross
        self.attn = Attention(hidden_size, num_heads, dtype=dtype, attn_backend=attn_backend)
        self.cross_attn = CrossAttention(hidden_size, num_heads, dtype=dtype,
                                         attn_backend=attn_backend)
        self.mlp = Mlp(hidden_size, int(hidden_size * mlp_ratio), dtype=dtype)
        self.adaLN_modulation = nn.Sequential(
            nn.SiLU(), Linear(hidden_size, 9 * hidden_size, dtype=dtype))

    def forward(self, x, c, context):
        (s_msa, sc_msa, g_msa, s_cross, sc_cross, g_cross,
         s_mlp, sc_mlp, g_mlp) = self.adaLN_modulation(c).chunk(9, dim=-1)
        x = x + g_msa[:, None, :] * self.attn(modulate(_layer_norm(x, self.dtype), s_msa, sc_msa))
        if self.use_cross:
            x = x + g_cross[:, None, :] * self.cross_attn(
                modulate(_layer_norm(x, self.dtype), s_cross, sc_cross), context)
        return x + g_mlp[:, None, :] * self.mlp(modulate(_layer_norm(x, self.dtype), s_mlp,
                                                         sc_mlp))


class DiTNVS(nn.Module):
    """DiT with DINO cross-attention at `cross_layers` (0-indexed)."""

    def __init__(self, input_size=32, patch_size=2, in_channels=4, hidden_size=1152, depth=28,
                 num_heads=16, mlp_ratio=4.0, class_dropout_prob=0.1, num_classes=1000,
                 learn_sigma=True, dino_dim=768, dino_patch_grid=16, cross_layers=(13, 15),
                 condition_on_labels=True, dtype=torch.float32, attn_backend="auto",
                 device="cuda", seed=0):
        super().__init__()
        device = resolve_device(device)
        for layer in cross_layers:
            if not 0 <= layer < depth:
                raise ValueError(f"cross layer {layer} out of range for depth {depth}")
        self.input_size = input_size
        self.patch_size = patch_size
        self.in_channels = in_channels
        self.out_channels = in_channels * 2 if learn_sigma else in_channels
        self.hidden_size = hidden_size
        self.depth = depth
        self.num_heads = num_heads
        self.num_classes = num_classes
        self.dino_dim = dino_dim
        self.dino_patch_grid = dino_patch_grid
        self.cross_layers = tuple(sorted(set(cross_layers)))
        self.condition_on_labels = condition_on_labels
        self.dtype = dtype

        self.x_embedder = PatchEmbed(patch_size, in_channels, hidden_size, dtype=dtype)
        self.t_embedder = TimestepEmbedder(hidden_size, dtype=dtype)
        self.y_embedder = LabelEmbedder(num_classes, hidden_size, class_dropout_prob)
        self.dino_embedder = PatchEmbed(1, dino_dim, hidden_size, dtype=dtype)
        pos = get_2d_sincos_pos_embed(hidden_size, input_size // patch_size)
        self.register_buffer("pos_embed", torch.from_numpy(pos.astype("float32")[None]))
        self.blocks = nn.ModuleList([
            DiTCrossBlock(hidden_size, num_heads, mlp_ratio=mlp_ratio, dtype=dtype,
                          attn_backend=attn_backend, use_cross=i in self.cross_layers)
            for i in range(depth)])
        self.final_layer = FinalLayer(hidden_size, patch_size, self.out_channels, dtype=dtype)
        self.initialize_weights(seed)
        self.to(device)

    def initialize_weights(self, seed: int) -> None:
        """The DiT's init (xavier-uniform linears, zeroed adaLN and head),
        then the DINO embedder xavier-uniform on its fans."""
        DiT.initialize_weights(self, seed)
        g = torch.Generator().manual_seed(seed + 1)
        _xavier_uniform_(self.dino_embedder.proj.weight, g)
        nn.init.zeros_(self.dino_embedder.proj.bias)

    def unpatchify(self, x):
        return DiT.unpatchify(self, x)

    def forward(self, x, t, dino_feat, y, *, train=False, force_drop_ids=None, generator=None):
        """x: (B, C, H, W), t: (B,) timesteps, dino_feat: (B, dino_dim, gh,
        gw) feature map, y: (B,) labels -> (B, out_channels, H, W) fp32.
        With `train`, labels drop to the null class with probability
        class_dropout_prob, drawn from `generator`; `force_drop_ids` wins."""
        x = self.x_embedder(x) + self.pos_embed.to(self.dtype)
        t_emb = self.t_embedder(t)
        y_emb = self.y_embedder(y, train, force_drop_ids, generator)
        c = t_emb + y_emb.to(t_emb.dtype) if self.condition_on_labels else t_emb
        context = self.dino_embedder(dino_feat)
        for block in self.blocks:
            x = block(x, c, context)
        return self.unpatchify(self.final_layer(x, c)).float()

    def forward_with_cfg(self, x, t, dino_feat, y, cfg_scale, *, guidance_channels: int = 3):
        """Classifier-free guidance over the doubled batch [cond ; uncond]:
        the first half of x mirrored, `dino_feat` and `y` of the whole batch,
        guidance on the first `guidance_channels` channels."""
        half = x[: x.shape[0] // 2]
        model_out = self(torch.cat([half, half], dim=0), t, dino_feat, y)
        eps, rest = model_out[:, :guidance_channels], model_out[:, guidance_channels:]
        cond_eps, uncond_eps = eps.chunk(2, dim=0)
        half_eps = uncond_eps + cfg_scale * (cond_eps - uncond_eps)
        return torch.cat([torch.cat([half_eps, half_eps], dim=0), rest], dim=1)
