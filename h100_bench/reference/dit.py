"""The DiT forward in plain fp32 PyTorch: the model of Peebles & Xie
(arXiv:2212.09748) as the configuration files state it.

Parameters are a dict of tensors under the reference implementation's
state-dict names (`blocks.{i}.attn.qkv.weight`, ...). `param_specs` lists
them with the standard deviation the benchmark draws each from.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .precision import EXACT, Precision

__all__ = ["param_specs", "pos_embed", "patch_tokens", "embed", "block", "block_stages",
           "final_layer", "forward", "guide",
           "forward_with_cfg", "attention", "mlp", "BIAS_STD"]

# every bias and the label table are drawn at these standard deviations; a
# weight at gain / sqrt(fan_in), with the gains below. Random weights with no
# zero-initialised head, so that every block and both outputs do work.
BIAS_STD = 0.02
TABLE_STD = 1.0
ADALN_GAIN = 0.5


def _width(cfg) -> int:
    return cfg["hidden_size"]


def param_specs(cfg) -> list:
    """[(name, shape, std)] of every parameter of the configuration."""
    D, p, C = cfg["hidden_size"], cfg["patch_size"], cfg["in_channels"]
    c_out = 2 * C if cfg["learn_sigma"] else C
    hidden = int(D * cfg["mlp_ratio"])
    freq = cfg["frequency_embedding_size"]
    table_rows = cfg["num_classes"] + int(cfg["class_dropout_prob"] > 0)
    specs = [("x_embedder.proj.weight", (D, C, p, p), 1 / math.sqrt(C * p * p)),
             ("x_embedder.proj.bias", (D,), BIAS_STD),
             ("t_embedder.mlp.0.weight", (D, freq), 1 / math.sqrt(freq)),
             ("t_embedder.mlp.0.bias", (D,), BIAS_STD),
             ("t_embedder.mlp.2.weight", (D, D), 1 / math.sqrt(D)),
             ("t_embedder.mlp.2.bias", (D,), BIAS_STD),
             ("y_embedder.embedding_table.weight", (table_rows, D), TABLE_STD)]
    for i in range(cfg["depth"]):
        b = f"blocks.{i}."
        specs += [(b + "attn.qkv.weight", (3 * D, D), 1 / math.sqrt(D)),
                  (b + "attn.qkv.bias", (3 * D,), BIAS_STD),
                  (b + "attn.proj.weight", (D, D), 1 / math.sqrt(D)),
                  (b + "attn.proj.bias", (D,), BIAS_STD),
                  (b + "mlp.fc1.weight", (hidden, D), 1 / math.sqrt(D)),
                  (b + "mlp.fc1.bias", (hidden,), BIAS_STD),
                  (b + "mlp.fc2.weight", (D, hidden), 1 / math.sqrt(hidden)),
                  (b + "mlp.fc2.bias", (D,), BIAS_STD),
                  (b + "adaLN_modulation.1.weight", (6 * D, D), ADALN_GAIN / math.sqrt(D)),
                  (b + "adaLN_modulation.1.bias", (6 * D,), BIAS_STD)]
    specs += [("final_layer.linear.weight", (p * p * c_out, D), 1 / math.sqrt(D)),
              ("final_layer.linear.bias", (p * p * c_out,), BIAS_STD),
              ("final_layer.adaLN_modulation.1.weight", (2 * D, D), ADALN_GAIN / math.sqrt(D)),
              ("final_layer.adaLN_modulation.1.bias", (2 * D,), BIAS_STD)]
    return specs


def pos_embed(cfg) -> torch.Tensor:
    """The frozen (1, N, D) 2-D sine-cosine table of the MAE code that DiT
    uses: per axis [sin | cos] over 1 / 10000^(2i/d), [h | w] halves, the
    grid built width first."""
    D = _width(cfg)
    grid = cfg["image_size"] // 8 // cfg["patch_size"]

    def one_axis(dim, pos):
        omega = 1.0 / 10000 ** (np.arange(dim // 2, dtype=np.float64) / (dim / 2.0))
        out = np.outer(pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    gw, gh = np.meshgrid(np.arange(grid, dtype=np.float32), np.arange(grid, dtype=np.float32))
    table = np.concatenate([one_axis(D // 2, gw), one_axis(D // 2, gh)], axis=1)
    return torch.from_numpy(table.astype(np.float32))[None]


def _timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(10000) * torch.arange(half, dtype=torch.float32,
                                                      device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _layer_norm(x):
    return F.layer_norm(x, (x.shape[-1],), eps=1e-6)


def _modulate(x, shift, scale):
    return x * (1 + scale[:, None, :]) + shift[:, None, :]


def mlp(W, prefix: str, h: torch.Tensor, cfg, prec: Precision = EXACT) -> torch.Tensor:
    """A block's tanh-GELU MLP."""
    return prec.linear(F.gelu(prec.linear(h, W[prefix + "fc1.weight"], W[prefix + "fc1.bias"]),
                              approximate="tanh"), W[prefix + "fc2.weight"], W[prefix + "fc2.bias"])


def attention(W, prefix, h, heads, prec: Precision = EXACT):
    """A block's attention branch from its modulated input: the packed qkv
    projection, softmax(q k^T / sqrt(hd)) v per head, the output projection."""
    B, T, D = h.shape
    hd = D // heads
    qkv = prec.linear(h, W[prefix + "qkv.weight"], W[prefix + "qkv.bias"])
    q, k, v = qkv.reshape(B, T, 3, heads, hd).permute(2, 0, 3, 1, 4)
    p = torch.softmax(prec.matmul(q, k.transpose(-1, -2)) * hd ** -0.5, dim=-1)
    o = prec.matmul(p, v).transpose(1, 2).reshape(B, T, D)
    return prec.linear(o, W[prefix + "proj.weight"], W[prefix + "proj.bias"])


def embed(W, cfg, t, y, prec: Precision = EXACT) -> torch.Tensor:
    """The conditioning c: the timestep's frequency embedding through its
    MLP, plus the label's row of the table."""
    temb = _timestep_embedding(t, cfg["frequency_embedding_size"])
    temb = prec.linear(F.silu(prec.linear(temb, W["t_embedder.mlp.0.weight"],
                                          W["t_embedder.mlp.0.bias"])),
                       W["t_embedder.mlp.2.weight"], W["t_embedder.mlp.2.bias"])
    return temb + W["y_embedder.embedding_table.weight"][y]


def block(W, cfg, i: int, h, c, prec: Precision = EXACT) -> torch.Tensor:
    """Block i, adaLN-Zero: shift, scale and gate of each branch from c."""
    b = f"blocks.{i}."
    mod = prec.linear(F.silu(c), W[b + "adaLN_modulation.1.weight"],
                      W[b + "adaLN_modulation.1.bias"])
    shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mod.chunk(6, dim=-1)
    h = h + gate_msa[:, None] * attention(
        W, b + "attn.", _modulate(_layer_norm(h), shift_msa, scale_msa), cfg["num_heads"], prec)
    m = mlp(W, b + "mlp.", _modulate(_layer_norm(h), shift_mlp, scale_mlp), cfg, prec)
    return h + gate_mlp[:, None] * m


def patch_tokens(W, cfg, x, prec: Precision = EXACT) -> torch.Tensor:
    """(B, C, H, W) latents -> (B, T, D) tokens: the patches, flattened in
    (C, p, p) order, through the patch projection, plus the position table."""
    D, p = cfg["hidden_size"], cfg["patch_size"]
    B, C, H, Wd = x.shape
    patches = x.reshape(B, C, H // p, p, Wd // p, p).permute(0, 2, 4, 1, 3, 5)
    return prec.linear(patches.reshape(B, (H // p) * (Wd // p), -1),
                       W["x_embedder.proj.weight"].reshape(D, -1),
                       W["x_embedder.proj.bias"]) + pos_embed(cfg).to(x.device)


def block_stages(W, cfg, i: int, x, c, h1, attn_out, h2, mlp_out,
                 prec: Precision = EXACT) -> dict:
    """Block i stage by stage, each stage from the given input to it: the
    attention's input from the block input x, the attention from its input
    h1, the MLP's input from x plus the gated attention output, the MLP
    from its input h2, the block output from x and both gated branch
    outputs."""
    b = f"blocks.{i}."
    mod = prec.linear(F.silu(c), W[b + "adaLN_modulation.1.weight"],
                      W[b + "adaLN_modulation.1.bias"])
    shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mod.chunk(6, dim=-1)
    x1 = x + gate_msa[:, None] * attn_out
    return {"attn_in": prec.act(_modulate(_layer_norm(x), shift_msa, scale_msa)),
            "attn": prec.act(attention(W, b + "attn.", h1, cfg["num_heads"], prec)),
            "mlp_in": prec.act(_modulate(_layer_norm(x1), shift_mlp, scale_mlp)),
            "mlp": prec.act(mlp(W, b + "mlp.", h2, cfg, prec)),
            "out": prec.act(x1 + gate_mlp[:, None] * mlp_out)}


def final_layer(W, h, c, prec: Precision = EXACT) -> torch.Tensor:
    """adaLN (shift, scale) and the linear head: (B, T, p * p * C_out)."""
    shift, scale = prec.linear(F.silu(c), W["final_layer.adaLN_modulation.1.weight"],
                               W["final_layer.adaLN_modulation.1.bias"]).chunk(2, dim=-1)
    return prec.linear(_modulate(_layer_norm(h), shift, scale), W["final_layer.linear.weight"],
                       W["final_layer.linear.bias"])


def forward(W, cfg, x, t, y, prec: Precision = EXACT) -> torch.Tensor:
    """x (B, C, H, W) latents, t (B,) timesteps of the 1000-step process,
    y (B,) labels (num_classes: the null label) -> (B, C_out, H, W)."""
    p = cfg["patch_size"]
    B, C, H, Wd = x.shape
    gh, gw = H // p, Wd // p
    h = patch_tokens(W, cfg, x, prec)
    c = embed(W, cfg, t, y, prec)
    for i in range(cfg["depth"]):
        h = block(W, cfg, i, h, c, prec)
    h = final_layer(W, h, c, prec)
    c_out = h.shape[-1] // (p * p)
    h = h.reshape(B, gh, gw, p, p, c_out)
    return torch.einsum("nhwpqc->nchpwq", h).reshape(B, c_out, gh * p, gw * p)


def guide(out: torch.Tensor, cfg_scale: float, guidance_channels: int = 3) -> torch.Tensor:
    """Classifier-free guidance of a [cond; uncond] output on its first
    three channels, as the reference DiT code does."""
    eps, rest = out[:, :guidance_channels], out[:, guidance_channels:]
    cond, uncond = eps.chunk(2)
    half_eps = uncond + cfg_scale * (cond - uncond)
    return torch.cat([torch.cat([half_eps, half_eps]), rest], dim=1)


def forward_with_cfg(W, cfg, x, t, y, cfg_scale: float, prec: Precision = EXACT) -> torch.Tensor:
    """The guided forward of the DiT sampler: the batch is [cond; uncond]
    (labels y, the null label in the second half) and the first half of x
    is run twice."""
    half = x[: x.shape[0] // 2]
    return guide(forward(W, cfg, torch.cat([half, half]), t, y, prec), cfg_scale)
