"""NVS evaluation metrics (counterpart of `fast_dit_tpu/nvs/metrics.py`,
which imports no JAX; the port keeps its own copy): PSNR, SSIM, the
Fréchet distance, FID and KID over an injected feature function, the
Inception score, LPIPS (the `lpips` package, imported when called), the
symmetric epipolar distance and TSED (OpenCV's SIFT, imported when called).
All numpy and scipy on the host.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

__all__ = [
    "psnr",
    "ssim",
    "frechet_distance",
    "compute_fid",
    "polynomial_mmd",
    "compute_kid",
    "inception_score",
    "compute_lpips",
    "symmetric_epipolar_distance",
    "compute_tsed",
]


# ---------------------------------------------------------------------------
# pixel metrics
# ---------------------------------------------------------------------------

def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 255.0) -> float:
    """Peak signal-to-noise ratio."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(20 * np.log10(data_range) - 10 * np.log10(mse))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    ax = np.arange(size) - size // 2
    g = np.exp(-(ax ** 2) / (2 * sigma ** 2))
    w = np.outer(g, g)
    return w / w.sum()


def _filter2(img: np.ndarray, win: np.ndarray) -> np.ndarray:
    from scipy.signal import convolve2d

    return convolve2d(img, win, mode="valid")


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 255.0) -> float:
    """Structural similarity, standard Wang et al. formulation with an 11x11
    Gaussian window."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 3:  # average over channels
        return float(np.mean([ssim(a[..., c], b[..., c], data_range)
                              for c in range(a.shape[-1])]))
    win = _gaussian_window()
    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2
    mu_a = _filter2(a, win)
    mu_b = _filter2(b, win)
    mu_aa, mu_bb, mu_ab = mu_a ** 2, mu_b ** 2, mu_a * mu_b
    s_aa = _filter2(a * a, win) - mu_aa
    s_bb = _filter2(b * b, win) - mu_bb
    s_ab = _filter2(a * b, win) - mu_ab
    num = (2 * mu_ab + C1) * (2 * s_ab + C2)
    den = (mu_aa + mu_bb + C1) * (s_aa + s_bb + C2)
    return float(np.mean(num / den))


# ---------------------------------------------------------------------------
# distribution metrics over injected features
# ---------------------------------------------------------------------------

def _activation_stats(feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    feats = np.asarray(feats, np.float64)
    return feats.mean(0), np.cov(feats, rowvar=False)


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """Frechet distance between two Gaussians (the FID core)."""
    from scipy import linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean, _ = linalg.sqrtm(sigma1 @ sigma2, disp=False)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def compute_fid(real_images, gen_images, feature_fn: Callable) -> float:
    """FID with an injected feature extractor: feature_fn(images) -> (N, D)."""
    mu1, s1 = _activation_stats(feature_fn(real_images))
    mu2, s2 = _activation_stats(feature_fn(gen_images))
    return frechet_distance(mu1, s1, mu2, s2)


def polynomial_mmd(x: np.ndarray, y: np.ndarray, degree: int = 3,
                   coef0: float = 1.0) -> float:
    """Unbiased MMD^2 with the KID polynomial kernel
    k(a, b) = (a.b / d + coef0)^degree."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    d = x.shape[1]
    kxx = (x @ x.T / d + coef0) ** degree
    kyy = (y @ y.T / d + coef0) ** degree
    kxy = (x @ y.T / d + coef0) ** degree
    m, n = len(x), len(y)
    sum_xx = (kxx.sum() - np.trace(kxx)) / (m * (m - 1))
    sum_yy = (kyy.sum() - np.trace(kyy)) / (n * (n - 1))
    return float(sum_xx + sum_yy - 2 * kxy.mean())


def compute_kid(real_images, gen_images, feature_fn: Callable,
                num_subsets: int = 10, subset_size: Optional[int] = None,
                seed: int = 0) -> Tuple[float, float]:
    """KID mean/std over random subsets."""
    fx = np.asarray(feature_fn(real_images))
    fy = np.asarray(feature_fn(gen_images))
    n = min(len(fx), len(fy))
    subset_size = subset_size or min(n, 1000)
    rs = np.random.RandomState(seed)
    vals = []
    for _ in range(num_subsets):
        ix = rs.choice(len(fx), subset_size, replace=False)
        iy = rs.choice(len(fy), subset_size, replace=False)
        vals.append(polynomial_mmd(fx[ix], fy[iy]))
    return float(np.mean(vals)), float(np.std(vals))


def inception_score(probs: np.ndarray, num_splits: int = 10) -> Tuple[float, float]:
    """IS from class probabilities (N, classes)."""
    probs = np.asarray(probs, np.float64)
    scores = []
    for chunk in np.array_split(probs, num_splits):
        marginal = chunk.mean(0, keepdims=True)
        kl = chunk * (np.log(chunk + 1e-12) - np.log(marginal + 1e-12))
        scores.append(np.exp(kl.sum(1).mean()))
    return float(np.mean(scores)), float(np.std(scores))


def compute_lpips(a, b, net: str = "alex") -> float:
    """LPIPS via the torch `lpips` package when installed; raises
    ImportError otherwise. a, b: (N, 3, H, W) in [-1, 1]."""
    import lpips  # soft dependency
    import torch

    model = lpips.LPIPS(net=net)
    with torch.no_grad():
        d = model(torch.from_numpy(np.asarray(a, np.float32)),
                  torch.from_numpy(np.asarray(b, np.float32)))
    return float(d.mean())


# ---------------------------------------------------------------------------
# TSED: thresholded symmetric epipolar distance (Zhou et al.)
# ---------------------------------------------------------------------------

def symmetric_epipolar_distance(pts1: np.ndarray, pts2: np.ndarray,
                                F: np.ndarray) -> np.ndarray:
    """Per-match symmetric epipolar distance under fundamental matrix F."""
    ones = np.ones((len(pts1), 1))
    x1 = np.concatenate([pts1, ones], 1)
    x2 = np.concatenate([pts2, ones], 1)
    l2 = x1 @ F.T      # lines in image 2
    l1 = x2 @ F        # lines in image 1
    num = np.abs(np.sum(x2 * l2, axis=1))
    d2 = num / np.maximum(np.linalg.norm(l2[:, :2], axis=1), 1e-12)
    d1 = num / np.maximum(np.linalg.norm(l1[:, :2], axis=1), 1e-12)
    return 0.5 * (d1 + d2)


def compute_tsed(img1: np.ndarray, img2: np.ndarray, F: np.ndarray,
                 threshold: float = 2.0, min_matches: int = 8) -> Optional[float]:
    """Fraction of SIFT matches whose symmetric epipolar distance is below
    `threshold`. Returns None when
    too few matches are found. Requires OpenCV."""
    import cv2

    def gray(im):
        im = np.asarray(im)
        if im.ndim == 3:
            im = cv2.cvtColor(im.astype(np.uint8), cv2.COLOR_RGB2GRAY)
        return im.astype(np.uint8)

    sift = cv2.SIFT_create()
    k1, d1 = sift.detectAndCompute(gray(img1), None)
    k2, d2 = sift.detectAndCompute(gray(img2), None)
    if d1 is None or d2 is None or len(k1) < min_matches or len(k2) < min_matches:
        return None
    matcher = cv2.BFMatcher(cv2.NORM_L2)
    raw = matcher.knnMatch(d1, d2, k=2)
    good = [m for m, n in raw if m.distance < 0.75 * n.distance]
    if len(good) < min_matches:
        return None
    pts1 = np.float32([k1[m.queryIdx].pt for m in good])
    pts2 = np.float32([k2[m.trainIdx].pt for m in good])
    d = symmetric_epipolar_distance(pts1, pts2, np.asarray(F, np.float64))
    return float(np.mean(d < threshold))
