"""Frozen 2D sine-cosine positional embeddings.

The port's own copy of the JAX package's construction
(`fast_dit_tpu/models/pos_embed.py`): per-axis 1D embeddings are [sin | cos]
over an fp64 omega ladder, concatenated [h | w], with the grid built
width-first (meshgrid(w, h)). The table must be bit-equal to the reference's
for `.pt` checkpoint compatibility, so the math matches it term for term.

Provenance: facebookresearch/mae (util/pos_embed.py, CC-BY-NC 4.0), which
the reference DiT credits and copies verbatim.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "get_1d_sincos_pos_embed_from_grid",
    "get_2d_sincos_pos_embed_from_grid",
    "get_2d_sincos_pos_embed",
]


def get_1d_sincos_pos_embed_from_grid(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    """(M,) positions -> (M, embed_dim) as [sin | cos]."""
    assert embed_dim % 2 == 0
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000 ** omega
    pos = pos.reshape(-1)
    out = np.einsum("m,d->md", pos, omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_2d_sincos_pos_embed_from_grid(embed_dim: int, grid: np.ndarray) -> np.ndarray:
    assert embed_dim % 2 == 0
    emb_h = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[0])
    emb_w = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[1])
    return np.concatenate([emb_h, emb_w], axis=1)


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int) -> np.ndarray:
    """(grid_size^2, embed_dim) fp64 table."""
    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.meshgrid(grid_w, grid_h)  # w goes first
    grid = np.stack(grid, axis=0).reshape([2, 1, grid_size, grid_size])
    return get_2d_sincos_pos_embed_from_grid(embed_dim, grid)
