"""Kernel K2: the fused log-mel spectrogram (``csrc/mel_kernel.cu``).

Replaces ``speech_editing_tpu/ops/pallas/mel_kernel.py::mel_spectrogram_pallas``.
Its plain version is ``ops/mel.py::mel_spectrogram``; the source note in
the ``.cu`` file gives the bound and the design.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from speech_editing_tpu_torch.ops.cuda.build import (check_status, check_tensor,
                                                     current_stream,
                                                     kernel_function, ptr)
from speech_editing_tpu_torch.ops.mel import MelConfig, mel_bases
from speech_editing_tpu_torch.ops.mel import mel_spectrogram as mel_spectrogram_plain

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P]


@functools.lru_cache(maxsize=4)
def _device_bases(cfg: MelConfig, device: torch.device):
    return tuple(torch.from_numpy(a).to(device) for a in mel_bases(cfg))


def mel_spectrogram(wav: torch.Tensor, cfg: MelConfig = MelConfig()) -> torch.Tensor:
    """[B, N] (or [N]) float32 wav -> [B, N // hop + 1, num_mels] log10 mel.

    A CPU tensor takes the plain version; a CUDA tensor launches K2."""
    if wav.dim() == 1:
        wav = wav[None]
    if wav.device.type == "cpu":
        return mel_spectrogram_plain(wav, cfg)
    if wav.device.type != "cuda":
        raise ValueError(f"mel_spectrogram: unsupported device {wav.device}")
    n_fft, hop = cfg.fft_size, cfg.hop_size
    n_bins = n_fft // 2 + 1
    if hop % 4 or n_fft % 4 or hop > n_fft or n_bins > 2048:
        raise ValueError(f"mel_spectrogram: unsupported n_fft={n_fft}, hop={hop}")
    b, n = wav.shape
    check_tensor(wav, "wav", (b, n), wav.device)
    cos_w, sin_w, fb_t = _device_bases(cfg, wav.device)
    out = torch.empty(b, n // hop + 1, cfg.num_mels, device=wav.device)
    fn = kernel_function("mel_kernel", "mel_spectrogram_f32", _ARGTYPES)
    check_status(fn(ptr(wav), ptr(cos_w), ptr(sin_w), ptr(fb_t), ptr(out),
                    b, n, n_fft, hop, n_bins, cfg.num_mels, cfg.eps,
                    current_stream()), "mel_spectrogram")
    mel_spectrogram.launches += 1
    return out


mel_spectrogram.launches = 0
