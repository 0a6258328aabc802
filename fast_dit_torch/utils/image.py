"""Image grid + PNG writer without Pillow (counterpart of
`fast_dit_tpu/utils/image.py`): the PNG is encoded with `zlib` and `struct`
(8-bit greyscale or RGB, no interlace, filter type 0 on every row)."""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

__all__ = ["make_grid", "save_image", "to_uint8", "encode_png"]


def to_uint8(img_nchw: np.ndarray, value_range=(-1.0, 1.0)) -> np.ndarray:
    """(B, C, H, W) floats -> (B, H, W, C) uint8 with clamp and rescale."""
    lo, hi = value_range
    x = (np.asarray(img_nchw, np.float32) - lo) / (hi - lo)
    x = np.clip(x * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return x.transpose(0, 2, 3, 1)


def make_grid(img_nchw: np.ndarray, nrow: int = 4, padding: int = 2,
              value_range=(-1.0, 1.0)) -> np.ndarray:
    """(B, C, H, W) -> (H', W', C) uint8 grid, `nrow` images per row."""
    imgs = to_uint8(img_nchw, value_range)
    B, H, W, C = imgs.shape
    nrows = (B + nrow - 1) // nrow
    grid = np.zeros((nrows * (H + padding) + padding,
                     nrow * (W + padding) + padding, C), np.uint8)
    for i in range(B):
        r, c = divmod(i, nrow)
        y = r * (H + padding) + padding
        x = c * (W + padding) + padding
        grid[y: y + H, x: x + W] = imgs[i]
    return grid


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """(H, W) or (H, W, 1|3) uint8 -> PNG bytes."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        color_type = 0
    elif img.ndim == 3 and img.shape[-1] == 3:
        color_type = 2
    else:
        raise ValueError(f"PNG writer takes 1 or 3 channels, got shape {img.shape}")
    h, w = img.shape[:2]
    rows = img.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b""))


def save_image(img_nchw: np.ndarray, path: str, nrow: int = 4,
               value_range=(-1.0, 1.0)) -> None:
    grid = make_grid(np.asarray(img_nchw), nrow=nrow, value_range=value_range)
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(grid))
