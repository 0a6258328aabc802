"""Centre-crop a folder of ground-truth images the ADM way.

    python -m fast_dit_torch.crop_gt --input GT_DIR [--output OUT_DIR] [--image-size 256]

Counterpart of `tools/crop_gt.py`, with its flags and output folder: every
image in `--input` (png, jpg, jpeg, webp, bmp) goes through the ADM centre
crop of `data.center_crop_arr` (BOX halving while the short side is at
least twice the target, a BICUBIC resize, the centre crop) and is saved
under its own name in `--output`, by default `<input>_cropped`. A host tool:
it needs Pillow, as JAX's does, and runs no kernel.
"""

from __future__ import annotations

import argparse
import os
import sys

from .data import center_crop_arr

__all__ = ["IMAGE_EXTS", "main"]

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".webp", ".bmp")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--input", required=True, help="folder of images")
    ap.add_argument("--output", default=None, help="output folder (default: <input>_cropped)")
    ap.add_argument("--image-size", type=int, default=256)
    args = ap.parse_args(argv)
    try:
        from PIL import Image
    except ImportError:
        raise SystemExit("fast_dit_torch.crop_gt: Pillow is not installed; it reads and "
                         "resizes the images (pip install pillow)") from None

    out_dir = args.output or args.input.rstrip("/") + "_cropped"
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    for fname in sorted(os.listdir(args.input)):
        if not fname.lower().endswith(IMAGE_EXTS):
            continue
        img = Image.open(os.path.join(args.input, fname)).convert("RGB")
        center_crop_arr(img, args.image_size).save(os.path.join(out_dir, fname))
        n += 1
    print(f"cropped {n} images -> {out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
