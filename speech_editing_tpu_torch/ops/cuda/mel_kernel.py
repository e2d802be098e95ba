"""Kernel K2: the fused log-mel spectrogram (``csrc/mel_kernel.cu``).

Replaces ``speech_editing_tpu/ops/pallas/mel_kernel.py::mel_spectrogram_pallas``.
Its plain version is ``ops/mel.py::mel_spectrogram``; the source note in
the ``.cu`` file gives the bound and the design (a real FFT of n_fft = 1024
in shared memory, one launch). The host tables it reads are made here:
the window, the FFT's twiddles and the mel filterbank packed band by band.
:func:`mel_kernel_takes` states K2's envelope; on the card a call outside it
raises, naming the kernel and the configuration.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from speech_editing_tpu_torch.ops.cuda.build import (check_status, check_tensor,
                                                     current_stream,
                                                     kernel_function, ptr)
from speech_editing_tpu_torch.ops.mel import MelConfig
from speech_editing_tpu_torch.ops.mel import mel_spectrogram as mel_spectrogram_plain
from speech_editing_tpu_torch.utils.audio.dsp import mel_filterbank, stft_window

N_FFT = 1024      # the one FFT size csrc/mel_kernel.cu is compiled for
MAX_MELS = 128    # two lanes a band in a CTA of 256 threads

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P]


class MelTables(NamedTuple):
    """What K2 reads beside the wav, float32 unless said otherwise."""
    window: np.ndarray     # [n_fft]
    twiddles: np.ndarray   # [761, 2] (re, im) at n_fft = 1024: see ``mel_tables``
    weights: np.ndarray    # [n_weights]: each band's weights over [lo, hi), band after band
    bands: np.ndarray      # [3, n_mels] int32: lo, hi (exclusive), offset into weights


def mel_bands(fb: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """A filterbank [n_mels, n_bins] as (bands [3, n_mels] int32, weights):
    band m's non-zero bins are [lo, hi), and weights[off : off + hi - lo]
    holds fb[m, lo:hi]. An empty band has lo = hi = 0."""
    bands = np.zeros((3, fb.shape[0]), np.int32)
    packed, off = [], 0
    for m, row in enumerate(fb):
        nz = np.flatnonzero(row)
        lo, hi = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0)
        bands[:, m] = lo, hi, off
        packed.append(row[lo:hi])
        off += hi - lo
    return bands, np.concatenate(packed).astype(np.float32)


@functools.lru_cache(maxsize=8)
def mel_tables(cfg: MelConfig) -> MelTables:
    """K2's tables for ``cfg``, computed in float64 and rounded to float32.

    The twiddles are laid out in the order the kernel's threads read them:
    a block for each radix-8 Stockham stage after the first (Ns = 8, 64),
    holding W_{n/2}^(r s n/2 / (8 Ns)) at row (r - 1) Ns + s (r = 1..7,
    s < Ns); then the split step's W_n^k for k <= n/4."""
    n = cfg.fft_size
    n2 = n // 2
    window = stft_window(cfg.window, cfg.win_length, n).astype(np.float32)
    r, angles, ns = np.arange(1, 8)[:, None], [], 8
    while ns < n2:
        angles.append(2 * np.pi * (r * np.arange(ns) * (n2 // (8 * ns))).ravel() / n2)
        ns *= 8
    angles = np.concatenate(angles + [2 * np.pi * np.arange(n // 4 + 1) / n])
    twiddles = np.stack([np.cos(angles), -np.sin(angles)], 1).astype(np.float32)
    fb = mel_filterbank(cfg.sample_rate, n, cfg.num_mels, cfg.fmin, cfg.fmax)
    bands, weights = mel_bands(fb)
    return MelTables(window, twiddles, weights, bands)


@functools.lru_cache(maxsize=4)
def _device_tables(cfg: MelConfig, device: torch.device) -> tuple[torch.Tensor, ...]:
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in mel_tables(cfg))


def mel_kernel_takes(cfg: MelConfig, dtype=torch.float32) -> bool:
    """Whether K2 runs this configuration: n_fft = 1024, a hop that is a
    multiple of 4 up to n_fft, at most 128 mel bands, a float32 wav."""
    hop = cfg.hop_size
    return (cfg.fft_size == N_FFT and hop % 4 == 0 and 0 < hop <= N_FFT
            and cfg.num_mels <= MAX_MELS and dtype == torch.float32)


def mel_spectrogram(wav: torch.Tensor, cfg: MelConfig = MelConfig()) -> torch.Tensor:
    """[B, N] (or [N]) float32 wav -> [B, N // hop + 1, num_mels] log10 mel.

    A CPU tensor takes the plain version; a CUDA tensor launches K2, and
    raises outside :func:`mel_kernel_takes`."""
    if wav.dim() == 1:
        wav = wav[None]
    if wav.device.type == "cpu":
        return mel_spectrogram_plain(wav, cfg)
    if wav.device.type != "cuda":
        raise ValueError(f"mel_spectrogram: unsupported device {wav.device}")
    hop = cfg.hop_size
    if not mel_kernel_takes(cfg, wav.dtype):
        raise ValueError(f"mel_spectrogram: n_fft={cfg.fft_size}, hop={hop}, "
                         f"num_mels={cfg.num_mels}, dtype {wav.dtype} is outside the kernel's "
                         "envelope; run it on the CPU")
    b, n = wav.shape
    check_tensor(wav, "wav", (b, n), wav.device)
    window, twiddles, weights, bands = _device_tables(cfg, wav.device)
    out = torch.empty(b, n // hop + 1, cfg.num_mels, device=wav.device)
    fn = kernel_function("mel_kernel", "mel_spectrogram_f32", _ARGTYPES)
    check_status(fn(ptr(wav), ptr(window), ptr(twiddles), ptr(weights), ptr(bands), ptr(out),
                    b, n, hop, cfg.num_mels, weights.numel(), cfg.eps, current_stream()),
                 "mel_spectrogram")
    mel_spectrogram.launches += 1
    return out


mel_spectrogram.launches = 0
