"""Procedural class-conditional image dataset: 10 classes of coloured
geometric shapes on gradient backgrounds, deterministic given (labels, seed).

Counterpart of `fast_dit_tpu/data/synthetic.py`, the port's own numpy copy
(the port imports nothing of the JAX package, not even its numpy-only
modules): `class_colors`, `synth_batch` and `synth_dataset` return arrays
byte-equal to JAX's for the same arguments. A DiT can be trained on it
with no dataset or weights on disk.

- class-conditional structure a small DiT must learn (shape type + class
  hue), with nuisance variation (position, scale, background gradient,
  colour jitter, stripe phase);
- pure numpy, vectorised per class group, no torch or PIL in the data path;
- output matches the training contract: float32 (B, 3, H, W) in [-1, 1],
  the layout `extract_features` feeds the trainer.
"""

from __future__ import annotations

import numpy as np

__all__ = ["NUM_CLASSES", "CLASS_NAMES", "class_colors", "synth_batch",
           "synth_dataset"]

NUM_CLASSES = 10
CLASS_NAMES = [
    "disk", "ring", "square", "diamond", "plus",
    "h-stripes", "v-stripes", "checker", "triangle", "twin-disks",
]

_EDGE = 0.02  # smoothstep half-width in canvas units (~0.6 px at 32x32)


def _hsv_to_rgb(h, s, v):
    h = np.asarray(h) % 1.0
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int64) % 6
    r = np.choose(i, [v, q, p, p, t, v])
    g = np.choose(i, [t, v, v, q, p, p])
    b = np.choose(i, [p, p, t, v, v, q])
    return np.stack([r, g, b], axis=-1)


def class_colors(num_classes: int = NUM_CLASSES) -> np.ndarray:
    """(K, 3) base RGB per class: evenly spaced hues, full saturation."""
    hues = np.arange(num_classes) / num_classes
    return _hsv_to_rgb(hues, np.full(num_classes, 0.85),
                       np.full(num_classes, 0.95))


def _shape_field(cls, dx, dy, r, aux):
    """Signed inside-ness s (s > 0 inside the shape) per class.

    dx, dy: (B, H, W) offsets from the shape center; r: (B, 1, 1) size;
    aux: dict of per-image nuisance draws (stripe freq/phase, blob angle).
    """
    d = np.sqrt(dx * dx + dy * dy)
    if cls == 0:    # disk
        return r - d
    if cls == 1:    # ring
        return 0.28 * r - np.abs(d - 0.85 * r)
    if cls == 2:    # square
        return r * 0.85 - np.maximum(np.abs(dx), np.abs(dy))
    if cls == 3:    # diamond
        return r * 1.15 - (np.abs(dx) + np.abs(dy))
    if cls == 4:    # plus
        arm = 0.38 * r
        h = np.minimum(r - np.abs(dx), arm - np.abs(dy))
        v = np.minimum(r - np.abs(dy), arm - np.abs(dx))
        return np.maximum(h, v)
    if cls == 5:    # horizontal stripes clipped to a disk
        stripes = 0.08 * np.sin(aux["freq"] * dy + aux["phase"])
        return np.minimum(r - d, stripes)
    if cls == 6:    # vertical stripes clipped to a disk
        stripes = 0.08 * np.sin(aux["freq"] * dx + aux["phase"])
        return np.minimum(r - d, stripes)
    if cls == 7:    # checkerboard clipped to a square
        box = r * 0.85 - np.maximum(np.abs(dx), np.abs(dy))
        checks = 0.08 * (np.sin(aux["freq"] * dx + aux["phase"])
                         * np.sin(aux["freq"] * dy + aux["phase2"]))
        return np.minimum(box, checks)
    if cls == 8:    # triangle, apex up
        base = 0.55 * r - dy          # below y = cy + 0.55 r
        sides = (dy + r) * 0.62 - np.abs(dx)
        return np.minimum(base, sides)
    if cls == 9:    # two disks along a random axis
        ox = aux["sep"] * np.cos(aux["angle"])
        oy = aux["sep"] * np.sin(aux["angle"])
        d1 = np.sqrt((dx - ox) ** 2 + (dy - oy) ** 2)
        d2 = np.sqrt((dx + ox) ** 2 + (dy + oy) ** 2)
        return np.maximum(0.55 * r - d1, 0.55 * r - d2)
    raise ValueError(f"class {cls} out of range [0, {NUM_CLASSES})")


def synth_batch(labels: np.ndarray, seed: int, image_size: int = 32) -> np.ndarray:
    """Render one batch: (B, 3, H, W) float32 in [-1, 1].

    Deterministic given (labels, seed); independent draws per (label array,
    seed) pair — pass distinct seeds for train/eval splits.
    """
    labels = np.asarray(labels, np.int64)
    if labels.ndim != 1:
        raise ValueError("labels must be 1-D")
    if ((labels < 0) | (labels >= NUM_CLASSES)).any():
        raise ValueError(f"labels must be in [0, {NUM_CLASSES})")
    B, H = labels.shape[0], image_size
    rng = np.random.default_rng(np.random.SeedSequence([0x5D17, seed]))

    # per-image nuisance parameters (drawn for the whole batch at once so the
    # stream is independent of the class composition)
    cx = rng.uniform(0.36, 0.64, B)
    cy = rng.uniform(0.36, 0.64, B)
    r = rng.uniform(0.16, 0.30, B)
    hue_jit = rng.uniform(-0.05, 0.05, B)
    val_jit = rng.uniform(-0.12, 0.08, B)
    g_amp = rng.uniform(0.08, 0.22, B)
    g_ang = rng.uniform(0.0, 2 * np.pi, B)
    g_base = rng.uniform(0.10, 0.30, B)
    freq = rng.uniform(28.0, 46.0, B)
    phase = rng.uniform(0.0, 2 * np.pi, B)
    phase2 = rng.uniform(0.0, 2 * np.pi, B)
    angle = rng.uniform(0.0, 2 * np.pi, B)
    sep = rng.uniform(0.45, 0.62, B) * r
    noise = rng.normal(0.0, 0.015, (B, H, H))

    ys, xs = np.meshgrid(np.linspace(0.0, 1.0, H), np.linspace(0.0, 1.0, H),
                         indexing="ij")
    out = np.empty((B, 3, H, H), np.float32)

    base = class_colors()
    hues = (np.arange(NUM_CLASSES) / NUM_CLASSES)
    for cls in range(NUM_CLASSES):
        idx = np.nonzero(labels == cls)[0]
        if idx.size == 0:
            continue
        dx = xs[None] - cx[idx, None, None]
        dy = ys[None] - cy[idx, None, None]
        aux = {"freq": freq[idx, None, None], "phase": phase[idx, None, None],
               "phase2": phase2[idx, None, None],
               "angle": angle[idx, None, None], "sep": sep[idx, None, None]}
        s = _shape_field(cls, dx, dy, r[idx, None, None], aux)
        # smooth edge: logistic on the signed field
        mask = 1.0 / (1.0 + np.exp(-s / _EDGE))
        color = _hsv_to_rgb(hues[cls] + hue_jit[idx],
                            np.full(idx.size, 0.85),
                            np.clip(0.95 + val_jit[idx], 0.0, 1.0))  # (n, 3)
        grad = (g_base[idx, None, None]
                + g_amp[idx, None, None]
                * ((xs[None] - 0.5) * np.cos(g_ang[idx, None, None])
                   + (ys[None] - 0.5) * np.sin(g_ang[idx, None, None])))
        bg = grad + noise[idx]                              # (n, H, W)
        img = (bg[:, None] * (1.0 - mask[:, None])
               + color[:, :, None, None] * mask[:, None])   # (n, 3, H, W)
        out[idx] = np.clip(img, 0.0, 1.0) * 2.0 - 1.0
    return out


def synth_dataset(num: int, seed: int, image_size: int = 32,
                  labels: np.ndarray = None):
    """(x, y): x (N, 3, H, W) in [-1, 1]; y balanced round-robin labels
    unless given."""
    if labels is None:
        labels = np.arange(num, dtype=np.int64) % NUM_CLASSES
        # shuffle so contiguous batches are class-mixed
        labels = np.random.default_rng(
            np.random.SeedSequence([0xDA7A, seed])).permutation(labels)
    return synth_batch(labels, seed, image_size), labels
