"""Log-mel spectrogram: the configuration and the plain PyTorch version.

The plain version computes the function of the fused kernel
(``ops/cuda/mel_kernel.py``) as dense products, the TPU kernel's
formulation: constant centre padding, the periodic Hann window folded into
cos/sin DFT bases, two DFT products, ``sqrt(re^2 + im^2 + 1e-30)``, the
slaney mel product and ``log10(max(eps, .))``. The kernel computes the
same bins by a real FFT and sums each mel band over its non-zero bins
only. Frames: ``N // hop + 1``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from speech_editing_tpu_torch.utils.audio.dsp import mel_filterbank, stft_window


@dataclass(frozen=True)
class MelConfig:
    sample_rate: int = 22050
    fft_size: int = 1024
    hop_size: int = 256
    win_length: int = 1024
    num_mels: int = 80
    fmin: float = 55.0
    fmax: float = 7600.0
    eps: float = 1e-6
    window: str = "hann"


@functools.lru_cache(maxsize=8)
def mel_bases(cfg: MelConfig) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(cos_w [n_fft, n_bins], sin_w [n_fft, n_bins], fb_t [n_bins, n_mels]),
    float32, with the window folded into the DFT bases."""
    n_fft = cfg.fft_size
    w = stft_window(cfg.window, cfg.win_length, n_fft).astype(np.float32)
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_fft // 2 + 1)[None, :]
    ang = -2.0 * np.pi * n * k / n_fft
    cos_w = w[:, None] * np.cos(ang).astype(np.float32)
    sin_w = w[:, None] * np.sin(ang).astype(np.float32)
    fb = mel_filterbank(cfg.sample_rate, n_fft, cfg.num_mels, cfg.fmin, cfg.fmax)
    return (np.ascontiguousarray(cos_w), np.ascontiguousarray(sin_w),
            np.ascontiguousarray(fb.T))


def mel_spectrogram(wav: torch.Tensor, cfg: MelConfig = MelConfig()) -> torch.Tensor:
    """[B, N] float32 wav -> [B, N // hop + 1, num_mels] log10 mel."""
    if wav.dim() == 1:
        wav = wav[None]
    cos_w, sin_w, fb_t = (torch.from_numpy(a).to(wav.device) for a in mel_bases(cfg))
    p = cfg.fft_size // 2
    frames = F.pad(wav.float(), (p, p)).unfold(1, cfg.fft_size, cfg.hop_size)
    re = frames @ cos_w
    im = frames @ sin_w
    amp = torch.sqrt(re * re + im * im + 1e-30)
    return torch.log10(torch.clamp(amp @ fb_t, min=cfg.eps))
