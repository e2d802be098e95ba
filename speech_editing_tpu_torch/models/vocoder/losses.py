"""HiFi-GAN training's spectral losses: the GAN-loss mel and the
multi-resolution STFT loss, the port of the JAX package's
``models/vocoder/losses.py``.

* :func:`gan_mel_spectrogram`: the wav clamped to [-1, 1], reflect-padded
  by ``(n_fft - hop) / 2`` on each side, framed without centring, a Hann
  window zero-padded to ``n_fft``, the magnitude ``sqrt(max(re^2 + im^2,
  1e-9))``, a slaney mel filterbank, ``log(max(mel, 1e-5))``;
* :func:`stft_magnitude`: centred reflect padding, magnitude eps 1e-7;
* :func:`multi_resolution_stft_loss`: spectral convergence (Frobenius
  norms over the whole batch) and the mean log-magnitude L1, averaged over
  three resolutions.

The DFT is two float32 products with cos and sin tables, as the JAX
package computes it (``HIGHEST`` precision matmuls, no Pallas kernel): a
library product (cuBLAS with TF32 off, ``float32_on_card``), not a kernel
of the port's.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from speech_editing_tpu_torch.parallel.mesh import active_data_mesh, global_mean, global_sums
from speech_editing_tpu_torch.utils.audio.dsp import mel_filterbank, stft_window


@functools.lru_cache(maxsize=16)
def _window(win_length: int, n_fft: int) -> np.ndarray:
    return stft_window("hann", win_length, n_fft).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _dft_matrices(n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
    """The real DFT as [n_fft, n_fft//2 + 1] cos and -sin tables."""
    k = np.arange(n_fft // 2 + 1)
    n = np.arange(n_fft)
    ang = 2.0 * np.pi * np.outer(n, k) / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _gan_mel_basis(sample_rate: int, n_fft: int, num_mels: int, fmin: float,
                   fmax: float) -> np.ndarray:
    return mel_filterbank(sample_rate, n_fft, num_mels, fmin, fmax)


def _const(table: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(table).to(like.device)


def _frames(wav: torch.Tensor, n_fft: int, hop: int, win_length: int) -> torch.Tensor:
    """[B, N] (padded) -> windowed frames [B, T, n_fft]."""
    return wav.unfold(1, n_fft, hop) * _const(_window(win_length, n_fft), wav)


def _rfft_magnitude(frames: torch.Tensor, n_fft: int, eps: float) -> torch.Tensor:
    """|rfft(frames)|, ``sqrt(max(re^2 + im^2, eps))``: [B, T, n_fft//2 + 1]."""
    cos_m, sin_m = _dft_matrices(n_fft)
    re = frames @ _const(cos_m, frames)
    im = frames @ _const(sin_m, frames)
    return torch.sqrt(torch.clamp(re * re + im * im, min=eps))


def _reflect(wav: torch.Tensor, left: int, right: int) -> torch.Tensor:
    return F.pad(wav[:, None], (left, right), mode="reflect")[:, 0]


def stft_magnitude(wav: torch.Tensor, n_fft: int, hop: int, win_length: int,
                   center: bool = True, eps: float = 1e-7) -> torch.Tensor:
    """[B, N] -> [B, T, n_fft//2 + 1] magnitude, framed as the reference's
    STFT frames: with ``center`` reflect-padded by n_fft/2, the window
    zero-padded to n_fft."""
    if center:
        wav = _reflect(wav, n_fft // 2, n_fft // 2)
    return _rfft_magnitude(_frames(wav, n_fft, hop, win_length), n_fft, eps)


def gan_mel_spectrogram(wav: torch.Tensor, hp) -> torch.Tensor:
    """[B, N] wav -> [B, T, num_mels] natural-log mel of the GAN loss
    (``center=False``)."""
    n_fft, hop = hp["fft_size"], hp["hop_size"]
    win = hp.get("win_size", n_fft)
    p = (n_fft - hop) // 2
    wav = _reflect(torch.clamp(wav, -1.0, 1.0), p, p)
    mag = _rfft_magnitude(_frames(wav, n_fft, hop, win), n_fft, 1e-9)
    basis = _gan_mel_basis(hp["audio_sample_rate"], n_fft, hp["audio_num_mel_bins"],
                           hp["fmin"], hp["fmax"])
    mel = mag @ _const(basis, mag).t()
    return torch.log(torch.clamp(mel, min=1e-5))


def _stft_loss_single(x, y, n_fft: int, hop: int, win: int):
    x_mag = stft_magnitude(x, n_fft, hop, win)
    y_mag = stft_magnitude(y, n_fft, hop, win)
    if active_data_mesh() is None:
        sc = torch.linalg.vector_norm(y_mag - x_mag) / torch.clamp(
            torch.linalg.vector_norm(y_mag), min=1e-8)
    else:   # the norms of the global batch
        num, den = global_sums(((y_mag - x_mag) ** 2).sum(), (y_mag ** 2).sum())
        sc = torch.sqrt(num) / torch.clamp(torch.sqrt(den), min=1e-8)
    mag = global_mean(torch.abs(torch.log(y_mag) - torch.log(x_mag)))
    return sc, mag


DEFAULT_RESOLUTIONS: Tuple[Tuple[int, int, int], ...] = (
    (1024, 120, 600), (2048, 240, 1200), (512, 50, 240))


def multi_resolution_stft_loss(x: torch.Tensor, y: torch.Tensor,
                               resolutions: Sequence[Tuple[int, int, int]] = DEFAULT_RESOLUTIONS
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(spectral convergence, log-magnitude) averaged over ``resolutions``
    of (n_fft, hop, win); x the predicted wav [B, N], y the ground truth."""
    sc_total, mag_total = 0.0, 0.0
    for n_fft, hop, win in resolutions:
        sc, mag = _stft_loss_single(x, y, n_fft, hop, win)
        sc_total = sc_total + sc
        mag_total = mag_total + mag
    n = len(resolutions)
    return sc_total / n, mag_total / n
