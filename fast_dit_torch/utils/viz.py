"""Visualization helpers (counterpart of `fast_dit_tpu/utils/viz.py`, which
imports no JAX; the port keeps its own copy): colormapped scalars, per-pixel
|gt - gen| error heatmaps, depth maps, attention overlays and 2D feature
embeddings. matplotlib, Pillow, scikit-learn and umap are imported only by
the functions that use them, so nothing else in the port needs them.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "colorize",
    "error_heatmap",
    "depth_to_color",
    "attention_overlay",
    "embed_features_2d",
]


def colorize(values: np.ndarray, cmap: str = "magma",
             vmin=None, vmax=None) -> np.ndarray:
    """(H, W) scalars -> (H, W, 3) uint8 through a matplotlib colormap."""
    import matplotlib.cm as cm

    values = np.asarray(values, np.float64)
    vmin = values.min() if vmin is None else vmin
    vmax = values.max() if vmax is None else vmax
    normed = (values - vmin) / max(vmax - vmin, 1e-12)
    rgba = cm.get_cmap(cmap)(np.clip(normed, 0, 1))
    return (rgba[..., :3] * 255).astype(np.uint8)


def error_heatmap(gt: np.ndarray, gen: np.ndarray, cmap: str = "magma") -> np.ndarray:
    """Per-pixel |gt - gen| magnitude -> colormapped uint8 image."""
    gt = np.asarray(gt, np.float64)
    gen = np.asarray(gen, np.float64)
    err = np.abs(gt - gen)
    if err.ndim == 3:
        err = err.mean(-1)
    return colorize(err, cmap)


def depth_to_color(depth: np.ndarray, cmap: str = "magma") -> np.ndarray:
    """Depth map -> colormapped uint8 image."""
    return colorize(depth, cmap)


def attention_overlay(image: np.ndarray, attn: np.ndarray,
                      alpha: float = 0.5, cmap: str = "magma") -> np.ndarray:
    """Blend a (h, w) attention map over an (H, W, 3) uint8 image."""
    from PIL import Image

    H, W = image.shape[:2]
    heat = colorize(attn, cmap)
    heat = np.asarray(Image.fromarray(heat).resize((W, H), Image.BILINEAR))
    out = (1 - alpha) * image.astype(np.float64) + alpha * heat.astype(np.float64)
    return np.clip(out, 0, 255).astype(np.uint8)


def embed_features_2d(features: np.ndarray, method: str = "tsne",
                      seed: int = 0) -> np.ndarray:
    """(N, D) features -> (N, 2) embedding via t-SNE (sklearn) or UMAP."""
    features = np.asarray(features, np.float64)
    if method == "tsne":
        from sklearn.manifold import TSNE

        perplexity = min(30.0, max(2.0, len(features) / 4))
        return TSNE(n_components=2, random_state=seed,
                    perplexity=perplexity).fit_transform(features)
    if method == "umap":
        import umap

        return umap.UMAP(n_components=2, random_state=seed).fit_transform(features)
    raise ValueError(f"unknown method: {method}")
