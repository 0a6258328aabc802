"""PNG folder -> mp4 (counterpart of `fast_dit_tpu/utils/video.py`, which
imports no JAX; the port keeps its own copy). OpenCV is imported only when
called."""

from __future__ import annotations

import os

__all__ = ["images_to_video"]


def images_to_video(image_folder: str, output_path: str, fps: int = 30,
                    ext: str = ".png") -> int:
    """Encode sorted `{image_folder}/*{ext}` into an mp4. Returns frame count."""
    import cv2

    frames = sorted(f for f in os.listdir(image_folder) if f.endswith(ext))
    if not frames:
        raise ValueError(f"no {ext} frames in {image_folder}")
    first = cv2.imread(os.path.join(image_folder, frames[0]))
    h, w = first.shape[:2]
    fourcc = cv2.VideoWriter_fourcc(*"mp4v")
    writer = cv2.VideoWriter(output_path, fourcc, fps, (w, h))
    try:
        for fname in frames:
            writer.write(cv2.imread(os.path.join(image_folder, fname)))
    finally:
        writer.release()
    return len(frames)
