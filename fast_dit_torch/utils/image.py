"""Image grid + PNG writer and reader without Pillow (counterpart of
`fast_dit_tpu/utils/image.py`): the PNG is encoded with `zlib` and `struct`
(8-bit greyscale or RGB, no interlace, filter type 0 on every row), and
`decode_png` reads back exactly that form."""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

__all__ = ["make_grid", "save_image", "to_uint8", "encode_png", "decode_png"]


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


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes as `encode_png` writes them -> (H, W) or (H, W, 3) uint8.
    Raises ValueError on any other form (bit depth, colour type, interlace,
    a row filter other than 0) or a damaged chunk."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError("truncated PNG chunk")
        (n,) = struct.unpack(">I", data[pos: pos + 4])
        kind, body = data[pos + 4: pos + 8], data[pos + 8: pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n: pos + 12 + n])
        if len(body) != n or crc != zlib.crc32(kind + body) & 0xFFFFFFFF:
            raise ValueError(f"damaged PNG chunk {kind!r}")
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color_type, compression, filt, interlace = header
    if depth != 8 or color_type not in (0, 2) or compression or filt or interlace:
        raise ValueError(f"PNG reader takes 8-bit grey or RGB, not interlaced; got bit depth "
                         f"{depth}, colour type {color_type}, interlace {interlace}")
    channels = 3 if color_type == 2 else 1
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * channels):
        raise ValueError(f"PNG data holds {raw.size} bytes, expected {h * (1 + w * channels)}")
    rows = raw.reshape(h, 1 + w * channels)
    if rows[:, 0].any():
        raise ValueError("PNG reader takes row filter type 0 only")
    img = rows[:, 1:].reshape(h, w, channels)
    return img[..., 0].copy() if channels == 1 else img.copy()


def save_image(img_nchw: np.ndarray, path: str, nrow: int = 4,
               value_range=(-1.0, 1.0)) -> None:
    grid = make_grid(np.asarray(img_nchw), nrow=nrow, value_range=value_range)
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(grid))
