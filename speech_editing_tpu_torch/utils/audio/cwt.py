"""The continuous wavelet transform of log-f0 over 10 dyadic Mexican-hat
scales: the binarizer's ``with_f0cwt`` targets (numpy, on the host), and
the reconstruction ``cwt2f0`` that FastSpeech2-orig runs on its predicted
coefficients (torch, on the model's device). The port's copy of the JAX
package's ``utils/audio/cwt.py``."""

from __future__ import annotations

import numpy as np
import torch

DT = 0.005


def _mexican_hat(t: np.ndarray) -> np.ndarray:
    return (1.0 - t ** 2) * np.exp(-t ** 2 / 2.0) * 2.0 / (np.sqrt(3.0) * np.pi ** 0.25)


def cwt_mexh(x: np.ndarray, num_scales: int = 10, dt: float = DT):
    """[T] -> (W [T, num_scales], scales), the scales dyadic: s_j = 2 dt 2^j."""
    t_len = len(x)
    scales = np.asarray([2.0 * dt * (2.0 ** j) for j in range(num_scales)])
    w = np.zeros((t_len, num_scales))
    for j, s in enumerate(scales):
        half = int(min(10.0 * s / dt, t_len))
        kernel = _mexican_hat((np.arange(-half, half + 1) * dt) / s) * (dt / np.sqrt(s))
        w[:, j] = np.convolve(x, kernel, mode="full")[half: half + t_len]
    return w, scales


def get_cont_lf0(f0: np.ndarray):
    """(uv, continuous log-f0): the unvoiced gaps of ``f0`` interpolated
    linearly; zeros when at most one frame is voiced."""
    uv = (f0 == 0).astype(np.float32)
    f0 = np.asarray(f0, np.float64)
    if (f0 > 0).sum() <= 1:
        return uv, np.zeros_like(f0)
    nz = np.where(f0 > 0)[0]
    return uv, np.log(np.interp(np.arange(len(f0)), nz, f0[nz]))


def norm_scale(w: np.ndarray):
    """Each column of ``w`` standardised: (normalised, mean, std)."""
    mean = w.mean(0, keepdims=True)
    std = w.std(0, keepdims=True) + 1e-8
    return (w - mean) / std, mean[0], std[0]


def get_lf0_cwt(lf0: np.ndarray, num_scales: int = 10):
    """Continuous lf0 [T] -> (W [T, num_scales], scales)."""
    return cwt_mexh(np.asarray(lf0, np.float64), num_scales)


def f0_to_cwt(f0: np.ndarray, num_scales: int = 10) -> dict:
    """Raw f0 [T] -> ``{"cwt_spec": [T, num_scales] float32, "cwt_mean",
    "cwt_std"}``: the continuous lf0 standardised by its own mean and std,
    then decomposed; the coefficients are stored raw."""
    _, lf0 = get_cont_lf0(f0)
    mean, std = float(lf0.mean()), float(lf0.std() + 1e-8)
    w, _ = get_lf0_cwt((lf0 - mean) / std, num_scales)
    return {"cwt_spec": w.astype(np.float32), "cwt_mean": mean, "cwt_std": std}


def cwt2f0(cwt_spec: torch.Tensor, mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    """Linear-domain f0 [B, T] from CWT coefficients [B, T, J] and the
    log-f0 ``mean`` and ``std`` [B]: the inverse transform's fixed weights
    (j + 3.5)^-2.5, each row standardised over time, then scaled by ``std``,
    shifted by ``mean`` and exponentiated."""
    num_scales = cwt_spec.shape[-1]
    widths = torch.tensor([(i + 1 + 2.5) ** (-2.5) for i in range(num_scales)],
                          dtype=cwt_spec.dtype, device=cwt_spec.device)
    lf0 = (cwt_spec * widths).sum(-1)
    lf0 = (lf0 - lf0.mean(-1, keepdim=True)) / (lf0.std(-1, unbiased=False, keepdim=True)
                                                + 1e-8)
    return torch.exp(lf0 * std[:, None] + mean[:, None])
