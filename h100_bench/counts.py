"""Operations and bytes from shapes, and the card's peaks: the yardstick of
the roofline and utilisation metrics.

Peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit: dense
bf16 989 TFLOP/s, HBM3 3.35 TB/s. Model FLOPs count each multiply-add as
two operations and only the work the model needs: the recomputed forward of
activation checkpointing is not counted.
"""

from __future__ import annotations

import math

from .reference.dit import param_specs

__all__ = ["PEAK_BF16_FLOPS", "HBM_BYTES_PER_S", "tokens", "forward_macs",
           "forward_flops", "train_flops_per_image", "trainable_params",
           "attention_fwd", "attention_bwd", "adamw_ema_bytes", "bound_s"]

PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def tokens(cfg) -> int:
    return (cfg["image_size"] // 8 // cfg["patch_size"]) ** 2


def forward_macs(cfg) -> int:
    """Multiply-adds of one image's forward. Each block: qkv and proj 4 D^2
    T, the MLP 8 D^2 T, the two attention products 2 T^2 D, adaLN 6 D^2;
    then the patch embedding, the timestep MLP, the final layer."""
    D, T, p, C = cfg["hidden_size"], tokens(cfg), cfg["patch_size"], cfg["in_channels"]
    hidden = int(D * cfg["mlp_ratio"])
    block = 4 * D * D * T + 2 * D * hidden * T + 2 * T * T * D + 6 * D * D
    c_out = 2 * C if cfg["learn_sigma"] else C
    rest = (T * C * p * p * D + cfg["frequency_embedding_size"] * D + D * D
            + 2 * D * D + T * D * p * p * c_out)
    return cfg["depth"] * block + rest


def forward_flops(cfg) -> int:
    return 2 * forward_macs(cfg)


def train_flops_per_image(cfg) -> int:
    """Forward and backward: three forwards' operations."""
    return 3 * forward_flops(cfg)


def trainable_params(cfg) -> int:
    """Elements the optimizer updates (the frozen position table is not
    one)."""
    return sum(math.prod(shape) for _, shape, _ in param_specs(cfg))


def attention_fwd(B, S, H, hd, elt=2, with_lse=False):
    """(bytes, FLOPs) of one kernel-1 call over packed (B, S, 3D) qkv: qkv
    read and the (B, S, D) output written once, the fp32 row LSE written
    where training keeps it; 4 B S^2 D operations."""
    D = H * hd
    nbytes = B * S * 4 * D * elt + (4 * B * S * H if with_lse else 0)
    return nbytes, 4 * B * S * S * D


def attention_bwd(B, S, H, hd, elt=2):
    """(bytes, FLOPs) of one kernel-2 call: qkv, the output, dO and the LSE
    read, the packed dqkv written once; 10 B S^2 D operations (the scores
    rebuilt, dV, dP, dQ, dK)."""
    D = H * hd
    return B * S * 8 * D * elt + 4 * B * S * H, 10 * B * S * S * D


def adamw_ema_bytes(n: int, nu_bytes: int = 4) -> int:
    """Kernel 3 over n elements: g, mu, nu, master, EMA read, param, mu, nu,
    master, EMA written, each once (bf16 param and mu)."""
    return n * (2 + 2 + 2 * 2 + 2 * nu_bytes + 16)


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the card could take: the larger of the bytes over HBM
    bandwidth and the operations over the bf16 peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS)
