"""Image-folder pipeline: the ADM centre crop, [-1, 1] normalisation and
class discovery (the port's own copy of `fast_dit_tpu/data/imagenet.py`).

numpy and Pillow only, no torch; Pillow is imported inside the functions
that decode images, so the package imports on a machine without it. Output
is NCHW fp32 in [-1, 1], ready for the VAE encoder.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["center_crop_arr", "load_image", "ImageFolderIndex"]

_IMG_EXTS = {".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif", ".tiff", ".webp"}


def center_crop_arr(pil_image, image_size: int):
    """ADM centre crop of a PIL image: halve with BOX while the short side
    is at least twice the target, resize with BICUBIC so the short side is
    the target, then crop the centre."""
    from PIL import Image

    while min(*pil_image.size) >= 2 * image_size:
        pil_image = pil_image.resize(
            tuple(x // 2 for x in pil_image.size), resample=Image.BOX)
    scale = image_size / min(*pil_image.size)
    pil_image = pil_image.resize(
        tuple(round(x * scale) for x in pil_image.size), resample=Image.BICUBIC)
    arr = np.array(pil_image)
    crop_y = (arr.shape[0] - image_size) // 2
    crop_x = (arr.shape[1] - image_size) // 2
    return Image.fromarray(arr[crop_y: crop_y + image_size, crop_x: crop_x + image_size])


def load_image(path: str, image_size: int, *, hflip: bool = False,
               rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Load -> ADM crop -> a horizontal flip with probability 1/2 drawn from
    `rng` (when `hflip`) -> (C, H, W) fp32 in [-1, 1]."""
    from PIL import Image

    with Image.open(path) as img:
        img = center_crop_arr(img.convert("RGB"), image_size)
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if hflip and rng is not None and rng.random() < 0.5:
        arr = arr[:, ::-1]
    arr = (arr - 0.5) / 0.5
    return np.ascontiguousarray(arr.transpose(2, 0, 1))


class ImageFolderIndex:
    """torchvision-ImageFolder-compatible (path, class) index: classes are
    the sorted subdirectory names, labels their sorted rank."""

    def __init__(self, root: str):
        self.root = root
        self.classes: List[str] = sorted(
            d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.samples: List[Tuple[str, int]] = []
        for c in self.classes:
            cdir = os.path.join(root, c)
            for fname in sorted(os.listdir(cdir)):
                if os.path.splitext(fname)[1].lower() in _IMG_EXTS:
                    self.samples.append((os.path.join(cdir, fname), self.class_to_idx[c]))

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, i: int) -> Tuple[str, int]:
        return self.samples[i]
