"""Model layer: the DiT backbones (dense and MoE) and their registry, and the SD-VAE."""

from .dit import REMAT_POLICIES, DiT, DiT_models, dit_config, dit_moe_config
from .layers import (
    Attention,
    DiTBlock,
    FinalLayer,
    LabelEmbedder,
    Mlp,
    PatchEmbed,
    QuantLinear,
    TimestepEmbedder,
    modulate,
)
from .moe import MoeMlp, expert_capacity
from .pos_embed import get_2d_sincos_pos_embed
from .vae import (VAE_SCALE, AutoencoderKL, DiagonalGaussian, decode_from_latents,
                  encode_to_latents)

__all__ = [
    "DiT",
    "DiT_models",
    "dit_config",
    "dit_moe_config",
    "MoeMlp",
    "expert_capacity",
    "QuantLinear",
    "REMAT_POLICIES",
    "Attention",
    "DiTBlock",
    "FinalLayer",
    "LabelEmbedder",
    "Mlp",
    "PatchEmbed",
    "TimestepEmbedder",
    "modulate",
    "get_2d_sincos_pos_embed",
    "AutoencoderKL",
    "DiagonalGaussian",
    "VAE_SCALE",
    "encode_to_latents",
    "decode_from_latents",
]
