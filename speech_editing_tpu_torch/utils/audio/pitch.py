"""f0 quantisation and de-normalisation on torch tensors, and the
dataset's f0 normalisation on host numpy."""

from __future__ import annotations

import math

import numpy as np
import torch


def f0_to_coarse(f0: torch.Tensor, f0_bin: int = 256, f0_max: float = 900.0,
                 f0_min: float = 50.0) -> torch.Tensor:
    """Quantize Hz f0 to coarse bins 1..255 (0 Hz -> bin 1), int64.

    ``torch.round`` rounds half to even, like ``numpy.rint``.
    """
    f0_mel_min = 1127 * math.log(1 + f0_min / 700)
    f0_mel_max = 1127 * math.log(1 + f0_max / 700)
    f0_mel = 1127 * torch.log(1 + f0 / 700)
    scaled = (f0_mel - f0_mel_min) * (f0_bin - 2) / (f0_mel_max - f0_mel_min) + 1
    f0_mel = torch.where(f0_mel > 0, scaled, f0_mel)
    return torch.round(f0_mel.clamp(1, f0_bin - 1)).long()


def denorm_f0(f0: torch.Tensor, uv: torch.Tensor | None,
              pitch_padding: torch.Tensor | None = None,
              f_min: float = 50.0, f_max: float = 900.0) -> torch.Tensor:
    """log2-normalised f0 -> Hz, zeroed where unvoiced or padded."""
    f0 = (2.0 ** f0).clamp(f_min, f_max)
    if uv is not None:
        f0 = torch.where(uv > 0, torch.zeros_like(f0), f0)
    if pitch_padding is not None:
        f0 = torch.where(pitch_padding, torch.zeros_like(f0), f0)
    return f0


def norm_interp_f0(f0: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host numpy, for the dataset: Hz f0 [T] -> (log2 f0 with the unvoiced
    frames (0 Hz) interpolated linearly between voiced neighbours, uv [T]),
    both float32."""
    f0 = np.asarray(f0, np.float32)
    uv = (f0 == 0).astype(np.float32)
    f0 = np.where(uv > 0, 0.0, np.log2(f0 + 1e-8)).astype(np.float32)
    if 0 < int(uv.sum()) < len(f0):
        voiced = np.where(uv == 0)[0]
        f0 = np.where(uv > 0, np.interp(np.arange(len(f0)), voiced,
                                        f0[voiced]).astype(np.float32), f0)
    return f0, uv
