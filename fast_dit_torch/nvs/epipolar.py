"""Epipolar attention: aggregate source-view features along epipolar lines
(counterpart of `fast_dit_tpu/nvs/epipolar.py`).

The soft band weight comes from the fundamental matrix, sigmoid(sharpness
(threshold - d)) of each source pixel's distance d to the target pixel's
epipolar line; its log is the attention logit, plus the feature affinity
f_tar^T f_src / sqrt(C) with `use_affinity`. JAX leaves these stock ops to
XLA (no Pallas kernel), and so do these.

Convention: F satisfies x_tar^T F x_src = 0. The epipolar line of target
pixel i in the source image is F^T x_tar_i.
"""

from __future__ import annotations

import torch

from .geometry import _homogeneous, _pixel_grid, point_line_distance

__all__ = ["patchify_attention_mask", "epipolar_weight_map", "epipolar_attention"]


def patchify_attention_mask(mask: torch.Tensor, patch_size: int = 16) -> torch.Tensor:
    """(B, H, W) mask -> (B, num_patches, 1) per-patch average."""
    B, H, W = mask.shape
    if H % patch_size or W % patch_size:
        raise ValueError("Height and Width must be divisible by patch_size.")
    gh, gw = H // patch_size, W // patch_size
    x = mask.reshape(B, gh, patch_size, gw, patch_size).mean(dim=(2, 4))
    return x.reshape(B, gh * gw, 1)


def epipolar_weight_map(F: torch.Tensor, h: int, w: int, *, threshold: float = 0.10,
                        sharpness: float = 5.0) -> torch.Tensor:
    """(..., 3, 3) F -> (..., h*w target, h*w source) soft epipolar band."""
    pts = _pixel_grid(h, w, F.dtype, F.device)
    lines_in_src = torch.einsum("...ji,nj->...ni", F, _homogeneous(pts))  # F^T x_tar
    d = point_line_distance(lines_in_src, pts.expand(*F.shape[:-2], *pts.shape))
    return torch.sigmoid(sharpness * (threshold - d))


def epipolar_attention(f_tar: torch.Tensor, f_src: torch.Tensor, F: torch.Tensor, *,
                       threshold: float = 0.10, sharpness: float = 5.0,
                       use_affinity: bool = False) -> torch.Tensor:
    """(B, C, H, W) target and source feature maps + (B, 3, 3) F ->
    (B, C, H, W) source features aggregated along each target pixel's
    epipolar line."""
    B, C, H, W = f_src.shape
    weights = epipolar_weight_map(F, H, W, threshold=threshold, sharpness=sharpness)
    logits = torch.log(weights.clamp(1e-12, 1.0))
    src_flat = f_src.reshape(B, C, H * W)
    if use_affinity:
        tar_flat = f_tar.reshape(B, C, H * W)
        logits = logits + torch.einsum("bci,bcj->bij", tar_flat, src_flat) * (C ** -0.5)
    attn = torch.softmax(logits, dim=-1)
    return torch.einsum("bij,bcj->bci", attn, src_flat).reshape(B, C, H, W)
