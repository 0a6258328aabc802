"""SD-VAE (AutoencoderKL, kl-f8) as `nn.Module`s (counterpart of
`fast_dit_tpu/models/vae.py`).

The standard kl-f8 architecture: 4 down/up stages at (128, 256, 512, 512)
channels, 2 resnets per encoder stage and 3 per decoder stage (the decoder's
stages in reverse order), GroupNorm(32, eps 1e-6) + SiLU, single-head
mid-block attention, the asymmetric (0, 1) pad before each stride-2
downsampling conv, nearest x2 then a 3x3 conv to upsample, and the
0.18215 latent scale.

Submodules carry diffusers' names (`encoder.down_blocks.{i}.resnets.{j}.norm1`,
`decoder.up_blocks.{i}.upsamplers.0.conv`,
`mid_block.attentions.0.{group_norm,to_q,to_k,to_v,to_out.0}`, `quant_conv`,
...), so a diffusers state dict loads with `load_state_dict(strict=True)`;
`up_blocks.0` is the deepest (widest) decoder stage, as in diffusers.

Layout is NCHW throughout, torch's native conv layout. Every module takes a
compute `dtype` as the DiT modules do: parameters stay fp32 and are cast at
use; GroupNorm statistics, the attention logits and the softmax are fp32.
cuDNN's TF32 setting is left to the caller (`utils.device.tf32`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device
from .layers import Linear

__all__ = ["AutoencoderKL", "DiagonalGaussian", "VAE_SCALE", "encode_to_latents",
           "decode_from_latents"]

VAE_SCALE = 0.18215


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` whose fp32 parameters are cast to `dtype` at use."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 dtype=torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding)
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt), self.stride,
                        self.padding)


class GroupNorm(nn.GroupNorm):
    """GroupNorm(32, eps 1e-6) with fp32 statistics and affine, the result
    cast to `dtype`."""

    def __init__(self, channels, dtype=torch.float32):
        super().__init__(32, channels, eps=1e-6)
        self.dtype = dtype

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias,
                            self.eps).to(self.dtype)


class ResnetBlock(nn.Module):
    def __init__(self, in_channels, out_channels, dtype=torch.float32):
        super().__init__()
        self.norm1 = GroupNorm(in_channels, dtype)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1, dtype=dtype)
        self.norm2 = GroupNorm(out_channels, dtype)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1, dtype=dtype)
        self.conv_shortcut = (Conv2d(in_channels, out_channels, 1, dtype=dtype)
                              if in_channels != out_channels else None)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x.to(h.dtype) + h


class AttnBlock(nn.Module):
    """Single-head self-attention over the spatial positions, scale C^-0.5,
    fp32 logits and softmax."""

    def __init__(self, channels, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.group_norm = GroupNorm(channels, dtype)
        self.to_q = Linear(channels, channels, dtype=dtype)
        self.to_k = Linear(channels, channels, dtype=dtype)
        self.to_v = Linear(channels, channels, dtype=dtype)
        self.to_out = nn.ModuleList([Linear(channels, channels, dtype=dtype)])

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.group_norm(x).reshape(B, C, H * W).transpose(1, 2)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        logits = torch.bmm(q, k.transpose(1, 2)).float() * C ** -0.5
        attn = torch.softmax(logits, dim=-1).to(self.dtype)
        h = self.to_out[0](torch.bmm(attn, v))
        return x.to(h.dtype) + h.transpose(1, 2).reshape(B, C, H, W)


class Downsample(nn.Module):
    def __init__(self, channels, dtype=torch.float32):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, dtype=dtype)

    def forward(self, x):
        # the asymmetric (0, 1) pad of kl-f8, then a stride-2 VALID conv
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, channels, dtype=torch.float32):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1, dtype=dtype)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


_RESAMPLERS = {"downsamplers": Downsample, "upsamplers": Upsample}


class _Stage(nn.Module):
    """One encoder or decoder stage: its resnets, then its resampler
    ("downsamplers" or "upsamplers", diffusers' name; None on the last
    stage)."""

    def __init__(self, in_channels, out_channels, n_resnets, resampler, dtype):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock(in_channels if j == 0 else out_channels, out_channels, dtype)
            for j in range(n_resnets)])
        self.resampler = resampler
        if resampler is not None:
            self.add_module(resampler, nn.ModuleList([_RESAMPLERS[resampler](out_channels,
                                                                              dtype)]))

    def forward(self, x):
        for resnet in self.resnets:
            x = resnet(x)
        if self.resampler is not None:
            x = getattr(self, self.resampler)[0](x)
        return x


class MidBlock(nn.Module):
    def __init__(self, channels, dtype=torch.float32):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(channels, channels, dtype)
                                      for _ in range(2)])
        self.attentions = nn.ModuleList([AttnBlock(channels, dtype)])

    def forward(self, x):
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class Encoder(nn.Module):
    def __init__(self, block_out_channels=(128, 256, 512, 512), layers_per_block=2,
                 latent_channels=4, dtype=torch.float32):
        super().__init__()
        ch = list(block_out_channels)
        self.conv_in = Conv2d(3, ch[0], 3, padding=1, dtype=dtype)
        self.down_blocks = nn.ModuleList([
            _Stage(ch[max(i - 1, 0)], c, layers_per_block,
                   "downsamplers" if i < len(ch) - 1 else None, dtype)
            for i, c in enumerate(ch)])
        self.mid_block = MidBlock(ch[-1], dtype)
        self.conv_norm_out = GroupNorm(ch[-1], dtype)
        self.conv_out = Conv2d(ch[-1], 2 * latent_channels, 3, padding=1, dtype=dtype)

    def forward(self, x):
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class Decoder(nn.Module):
    def __init__(self, block_out_channels=(128, 256, 512, 512), layers_per_block=3,
                 latent_channels=4, out_channels=3, dtype=torch.float32):
        super().__init__()
        rev = list(reversed(block_out_channels))  # (512, 512, 256, 128)
        self.conv_in = Conv2d(latent_channels, rev[0], 3, padding=1, dtype=dtype)
        self.mid_block = MidBlock(rev[0], dtype)
        self.up_blocks = nn.ModuleList([
            _Stage(rev[max(i - 1, 0)], c, layers_per_block,
                   "upsamplers" if i < len(rev) - 1 else None, dtype)
            for i, c in enumerate(rev)])
        self.conv_norm_out = GroupNorm(rev[-1], dtype)
        self.conv_out = Conv2d(rev[-1], out_channels, 3, padding=1, dtype=dtype)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class DiagonalGaussian:
    """The latent distribution over NCHW moments (mean | logvar on the
    channel axis), logvar clamped to [-30, 20]."""

    def __init__(self, moments: torch.Tensor):
        self.mean, logvar = moments.chunk(2, dim=1)
        self.logvar = logvar.clamp(-30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)

    def sample(self, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mean + std * eps, eps drawn from `generator` or given as `noise`."""
        if noise is None:
            if generator is None:
                raise ValueError("either `generator` or `noise` must be given")
            noise = torch.randn(self.mean.shape, generator=generator,
                                dtype=self.mean.dtype, device=self.mean.device)
        return self.mean + self.std * noise.to(self.mean)

    def mode(self) -> torch.Tensor:
        return self.mean


class AutoencoderKL(nn.Module):
    """kl-f8 VAE: `encode_moments` (B, 3, H, W) -> (B, 2 * latent, H/f, W/f)
    and `decode` (B, latent, h, w) unscaled latents -> (B, 3, f*h, f*w)
    images, f = 2^(stages - 1). Outputs are fp32.

    Built on `device` ("cuda" unless the caller asks for the CPU) with
    torch's default init; the weights come through `ckpt.vae_import`."""

    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 latent_channels: int = 4, dtype=torch.float32, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.block_out_channels = tuple(int(c) for c in block_out_channels)
        self.latent_channels = latent_channels
        self.dtype = dtype
        self.encoder = Encoder(self.block_out_channels, 2, latent_channels, dtype)
        self.decoder = Decoder(self.block_out_channels, 3, latent_channels, 3, dtype)
        self.quant_conv = Conv2d(2 * latent_channels, 2 * latent_channels, 1, dtype=dtype)
        self.post_quant_conv = Conv2d(latent_channels, latent_channels, 1, dtype=dtype)
        self.to(device)

    def encode_moments(self, x: torch.Tensor) -> torch.Tensor:
        return self.quant_conv(self.encoder(x)).float()

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z)).float()


def encode_to_latents(vae: AutoencoderKL, x: torch.Tensor, generator=None,
                      noise=None) -> torch.Tensor:
    """images -> scaled latents: a sample of the latent distribution x 0.18215."""
    return DiagonalGaussian(vae.encode_moments(x)).sample(generator, noise) * VAE_SCALE


def decode_from_latents(vae: AutoencoderKL, z: torch.Tensor) -> torch.Tensor:
    """scaled latents -> images: decode(z / 0.18215)."""
    return vae.decode(z / VAE_SCALE)
