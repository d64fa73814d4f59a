"""SSIM matching kornia 0.5.3's `ssim(img1, img2, window_size=3)` semantics
(the reference metric, metrics.py:116-121): gaussian window (sigma = 1.5),
'same' spatial output via reflect padding, per-channel SSIM index map,
C1 = (0.01*max_val)^2, C2 = (0.03*max_val)^2; the reported scalar is the mean
of the map over channels and pixels.
"""

from __future__ import annotations

import numpy as np


def _gaussian_kernel(window_size: int, sigma: float) -> np.ndarray:
    half = (window_size - 1) / 2.0
    x = np.arange(window_size, dtype=np.float64) - half
    g = np.exp(-(x**2) / (2.0 * sigma**2))
    return g / g.sum()


def _filter2d_separable(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Reflect-padded separable 2D filtering over the last two axes of
    (C, H, W)."""
    pad = len(k) // 2
    # rows
    p = np.pad(img, ((0, 0), (pad, pad), (0, 0)), mode="reflect")
    out = np.zeros_like(img, dtype=np.float64)
    for i, w in enumerate(k):
        out += w * p[:, i : i + img.shape[1], :]
    # cols
    p = np.pad(out, ((0, 0), (0, 0), (pad, pad)), mode="reflect")
    out2 = np.zeros_like(img, dtype=np.float64)
    for i, w in enumerate(k):
        out2 += w * p[:, :, i : i + img.shape[2]]
    return out2


def ssim_map(img1: np.ndarray, img2: np.ndarray, window_size: int = 3,
             max_val: float = 1.0) -> np.ndarray:
    """Per-pixel SSIM index map for (C, H, W) images in [0, max_val]."""
    img1 = np.asarray(img1, np.float64)
    img2 = np.asarray(img2, np.float64)
    if img1.ndim == 2:
        img1, img2 = img1[None], img2[None]
    k = _gaussian_kernel(window_size, 1.5)

    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2

    mu1 = _filter2d_separable(img1, k)
    mu2 = _filter2d_separable(img2, k)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _filter2d_separable(img1 * img1, k) - mu1_sq
    sigma2_sq = _filter2d_separable(img2 * img2, k) - mu2_sq
    sigma12 = _filter2d_separable(img1 * img2, k) - mu12

    num = (2 * mu12 + c1) * (2 * sigma12 + c2)
    den = (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    return num / den


def ssim(img1: np.ndarray, img2: np.ndarray, window_size: int = 3,
         max_val: float = 1.0) -> float:
    """Scalar SSIM — mean of the index map (reference metrics.py:121)."""
    return float(np.mean(ssim_map(img1, img2, window_size, max_val)))


def psnr(pred: np.ndarray, gt: np.ndarray, valid_mask=None) -> float:
    """-10 log10 MSE (reference metrics.py:105-114)."""
    err = (np.asarray(pred, np.float64) - np.asarray(gt, np.float64)) ** 2
    if valid_mask is not None:
        err = err[valid_mask]
    return float(-10.0 * np.log10(np.mean(err)))
