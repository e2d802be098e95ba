"""SSIM (11-tap Gaussian window, sigma 1.5) for the mel SSIM loss.

Each separable 1-D blur is a product with a banded [n, n] matrix, the same
function as a SAME zero-padded convolution; the matrices are cached per
(length, device). C1 = 1e-4, C2 = 9e-4.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _gaussian_window(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(window_size) - window_size // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


@functools.lru_cache(maxsize=32)
def band_matrix(n: int, device: torch.device, window_size: int = 11,
                sigma: float = 1.5) -> torch.Tensor:
    """[n, n] banded Gaussian operator: ``m @ x`` blurs x along its rows."""
    g = _gaussian_window(window_size, sigma)
    pad = window_size // 2
    m = np.zeros((n, n), np.float32)
    for k in range(window_size):
        off = k - pad
        m += np.diag(np.full(n - abs(off), g[k], np.float32), off)
    return torch.from_numpy(m).to(device)


def _blur(img: torch.Tensor, window_size: int) -> torch.Tensor:
    """Separable Gaussian blur over the last two dims of [B, T, M]."""
    wt = band_matrix(img.shape[1], img.device, window_size)
    wm = band_matrix(img.shape[2], img.device, window_size)
    return torch.einsum("ts,bsm->btm", wt, img) @ wm


def ssim_map(img1: torch.Tensor, img2: torch.Tensor,
             window_size: int = 11) -> torch.Tensor:
    """Per-pixel SSIM of two [B, T, M] images (values expected >= 0)."""
    img1, img2 = img1.float(), img2.float()
    mu1, mu2 = _blur(img1, window_size), _blur(img2, window_size)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _blur(img1 * img1, window_size) - mu1_sq
    sigma2_sq = _blur(img2 * img2, window_size) - mu2_sq
    sigma12 = _blur(img1 * img2, window_size) - mu1_mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
