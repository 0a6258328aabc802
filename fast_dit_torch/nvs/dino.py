"""DINO/DINOv2 feature extraction for the NVS model's cross-attention
(counterpart of `fast_dit_tpu/nvs/dino.py`, which imports no JAX; the port
keeps its own copy).

`load_dino` loads the model from a local directory holding a `hubconf.py`
(a dinov2 checkout) with `torch.hub.load(..., source="local")`, on the
caller's device ("cuda" unless the caller asks for the CPU). It never
downloads: where JAX's loader falls back to fetching the hub repository,
this one raises. The extractor emits (B, C*len(layers), gh, gw) maps shaped
for `DiTNVS`'s `dino_feat`; `random_dino_features` makes seeded stand-ins
of that shape where no weights are at hand.
"""

from __future__ import annotations

import os
from typing import Callable, Sequence

import numpy as np
import torch

from ..utils.device import resolve_device

__all__ = ["load_dino", "preprocess_images", "random_dino_features"]

DINO_PATCH = 14
_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def preprocess_images(images: np.ndarray) -> np.ndarray:
    """uint8/float (B, H, W, 3) in [0, 255] -> fp32 NCHW, ImageNet-normalized."""
    x = np.asarray(images, np.float32) / 255.0
    x = np.transpose(x, (0, 3, 1, 2))
    mean = _IMAGENET_MEAN.reshape(1, 3, 1, 1)
    std = _IMAGENET_STD.reshape(1, 3, 1, 1)
    return (x - mean) / std


def load_dino(model_name: str = "dinov2_vitb14", *, layers: Sequence[int] = (-1,),
              hub_dir: str = None, device="cuda") -> Callable:
    """-> extract(images_uint8 (B, H, W, 3)) -> (B, C*len(layers), gh, gw) numpy.

    `layers` are negative indices from the last transformer layer (-1 =
    final), concatenated along channels in the given order. `hub_dir` is a
    local directory with a `hubconf.py`.
    """
    if not layers or any(i >= 0 for i in layers):
        raise ValueError(
            f"layers must be negative indices from the last layer, e.g. "
            f"(-1,) or (-1, -3); got {tuple(layers)}")
    if not (hub_dir and os.path.exists(os.path.join(hub_dir, "hubconf.py"))):
        raise FileNotFoundError(
            f"no hubconf.py in hub_dir={hub_dir!r}: DINO loads from a local dinov2 "
            f"checkout (torch.hub source='local') and is never downloaded")
    device = resolve_device(device)
    n = max(-i for i in layers)
    model = torch.hub.load(hub_dir, model_name, source="local").to(device).eval()

    def extract(images: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(preprocess_images(images)).to(device)
        with torch.no_grad():
            # the last n layers' maps, each reshaped to (B, C, H/14, W/14)
            feats = model.get_intermediate_layers(x, n=n, reshape=True)
        return torch.cat([feats[i] for i in layers], dim=1).cpu().numpy()

    return extract


def random_dino_features(batch: int, grid: int = 16, dim: int = 768,
                         seed: int = 0) -> np.ndarray:
    """Shape-compatible random stand-in features for offline use."""
    rs = np.random.RandomState(seed)
    return rs.randn(batch, dim, grid, grid).astype(np.float32)
