"""Evaluate generated samples (counterpart of `tools/evaluate_samples.py`):
FID, KID and IS from ADM-style npz files or image folders, and paired PSNR,
SSIM, LPIPS and TSED for NVS outputs, over `nvs.metrics`.

    python -m fast_dit_torch.evaluate_samples --generated gen.npz --reference ref.npz \
        --feature-net random [--paired] [--tsed-poses F.npz]

The FID family needs a feature extractor. `--feature-net random` is a fixed
random projection of pooled pixels (not a trained net: it exercises the
pipeline where no weights are at hand). `--feature-net inception` uses
Keras' InceptionV3 from a local weights file (`--inception-weights`) when
TensorFlow is installed; the port never downloads them, so without the file
the FID family is skipped with JAX's message. Metrics run on the host.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .nvs import metrics
from .utils.image import decode_png

__all__ = ["load_images", "make_random_projection_fns", "make_inception_fns", "main"]


def _read_image(path):
    if path.lower().endswith(".png"):
        try:
            with open(path, "rb") as f:
                img = decode_png(f.read())
            return np.repeat(img[..., None], 3, axis=-1) if img.ndim == 2 else img
        except ValueError:  # a PNG form the port's reader does not take
            pass
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def load_images(path, limit=None):
    """npz (arr_0) or a folder of images -> (N, H, W, 3) uint8."""
    if path.endswith(".npz"):
        arr = np.load(path)["arr_0"]
        return arr[:limit] if limit else arr
    files = sorted(f for f in os.listdir(path) if f.lower().endswith((".png", ".jpg", ".jpeg")))
    if limit:
        files = files[:limit]
    return np.stack([_read_image(os.path.join(path, f)) for f in files])


def make_random_projection_fns(feature_dim=64, n_classes=100, seed=0):
    """A deterministic offline stand-in for InceptionV3: 8x8-average-pooled
    pixels through a fixed Gaussian projection (features for FID and KID)
    and a second projection + softmax (class probabilities for IS). Every
    call projects through the same matrices, pinned to the first batch's
    pooled size; image sets of another resolution are refused."""

    def pooled(imgs):
        x = imgs.astype(np.float64) / 127.5 - 1.0
        n, h, w, c = x.shape
        ph, pw = max(h // 8, 1), max(w // 8, 1)
        x = x[:, : (h // ph) * ph, : (w // pw) * pw]
        x = x.reshape(n, h // ph, ph, w // pw, pw, c).mean((2, 4))
        return x.reshape(n, -1)

    w_feat = w_cls = None

    def _check_dim(w, x):
        if w.shape[0] != x.shape[1]:
            raise ValueError(
                f"image sets have different pooled feature dims "
                f"({w.shape[0]} vs {x.shape[1]}): reference and generated "
                f"sets must share one resolution for random-projection "
                f"FID/KID/IS to be meaningful")

    def feature_fn(imgs):
        nonlocal w_feat
        x = pooled(imgs)
        if w_feat is None:
            w_feat = np.random.RandomState(seed).randn(
                x.shape[1], feature_dim) / np.sqrt(x.shape[1])
        _check_dim(w_feat, x)
        return np.tanh(x @ w_feat)

    def logits_fn(imgs):
        nonlocal w_cls
        x = pooled(imgs)
        if w_cls is None:
            w_cls = np.random.RandomState(seed + 1).randn(
                x.shape[1], n_classes) / np.sqrt(x.shape[1])
        _check_dim(w_cls, x)
        z = x @ w_cls
        e = np.exp(z - z.max(1, keepdims=True))
        return e / e.sum(1, keepdims=True)

    return feature_fn, logits_fn


def make_inception_fns(weights=None):
    """(feature_fn, logits_fn) of Keras' InceptionV3 with the local
    `weights` file, or (None, None) with JAX's message when there is no
    such file or TensorFlow."""
    try:
        if not (weights and os.path.isfile(weights)):
            raise FileNotFoundError(f"no local InceptionV3 weights file ({weights!r})")
        import tensorflow as tf

        model = tf.keras.applications.InceptionV3(include_top=True, weights=weights)
        feat_model = tf.keras.Model(model.input, model.get_layer("avg_pool").output)

        def prep(imgs):
            x = tf.image.resize(imgs.astype(np.float32), (299, 299))
            return tf.keras.applications.inception_v3.preprocess_input(x)

        def feature_fn(imgs):
            return feat_model.predict(prep(imgs), verbose=0, batch_size=64)

        def logits_fn(imgs):
            return model.predict(prep(imgs), verbose=0, batch_size=64)

        return feature_fn, logits_fn
    except (ImportError, OSError, ValueError) as e:
        print(f"# InceptionV3 unavailable ({type(e).__name__}); skipping FID/KID/IS",
              file=sys.stderr)
        return None, None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--generated", required=True, help="npz or folder")
    ap.add_argument("--reference", default=None, help="npz or folder (for FID/KID)")
    ap.add_argument("--paired", action="store_true",
                    help="treat generated/reference as aligned pairs (PSNR/SSIM/LPIPS)")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--tsed-poses", default=None,
                    help="npz with F matrices (key arr_0, one per adjacent pair) for TSED "
                         "consistency")
    ap.add_argument("--feature-net", default="inception", choices=["inception", "random"],
                    help="'random' = fixed-seed projection features (offline FID/KID/IS "
                         "pipeline exercise; not a trained net)")
    ap.add_argument("--inception-weights", default=None,
                    help="local Keras InceptionV3 weights file (never downloaded)")
    args = ap.parse_args(argv)

    gen = load_images(args.generated, args.limit)
    print(f"generated: {gen.shape}")
    results = {}
    if args.reference:
        ref = load_images(args.reference, args.limit)
        if args.paired:
            n = min(len(gen), len(ref))
            results["psnr"] = float(np.mean([metrics.psnr(ref[i], gen[i]) for i in range(n)]))
            results["ssim"] = float(np.mean([metrics.ssim(ref[i], gen[i]) for i in range(n)]))
            try:
                a = (gen[:n].transpose(0, 3, 1, 2) / 127.5 - 1).astype(np.float32)
                b = (ref[:n].transpose(0, 3, 1, 2) / 127.5 - 1).astype(np.float32)
                results["lpips"] = metrics.compute_lpips(a, b)
            except ImportError:
                print("# lpips package unavailable; skipping LPIPS", file=sys.stderr)
        feature_fn, logits_fn = (make_random_projection_fns() if args.feature_net == "random"
                                 else make_inception_fns(args.inception_weights))
        if feature_fn is not None:
            results["fid"] = metrics.compute_fid(ref, gen, feature_fn)
            results["kid"] = metrics.compute_kid(ref, gen, feature_fn)[0]
            probs = logits_fn(gen)
            probs = probs / probs.sum(axis=1, keepdims=True)
            results["inception_score"] = metrics.inception_score(np.clip(probs, 1e-12, 1))[0]
    if args.tsed_poses:
        Fs = np.load(args.tsed_poses)["arr_0"]
        scores = [s for s in (metrics.compute_tsed(gen[i], gen[i + 1], Fs[i])
                              for i in range(min(len(gen) - 1, len(Fs)))) if s is not None]
        if scores:
            results["tsed"] = float(np.mean(scores))
    for k, v in results.items():
        print(f"{k}: {v:.4f}")
    return results


if __name__ == "__main__":
    main()
