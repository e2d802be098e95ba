"""Wav file IO with scipy: the port's copy of the JAX package's
``utils/audio/io.py``."""

from __future__ import annotations

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


def load_wav(path: str, sample_rate: int | None = None) -> tuple[np.ndarray, int]:
    """Load a wav as float32 in [-1, 1], mono, optionally resampled."""
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        wav = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        wav = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        wav = (data.astype(np.float32) - 128.0) / 128.0
    else:
        wav = data.astype(np.float32)
    if wav.ndim == 2:
        wav = wav.mean(axis=1)
    if sample_rate is not None and sr != sample_rate:
        g = np.gcd(int(sr), int(sample_rate))
        wav = resample_poly(wav, sample_rate // g, sr // g).astype(np.float32)
        sr = sample_rate
    return wav, sr


def save_wav(wav: np.ndarray, path: str, sr: int, norm: bool = False):
    """Save a float wav as 16-bit PCM; int16 input is written unchanged."""
    wav = np.asarray(wav)
    if wav.dtype == np.int16 and not norm:
        wavfile.write(path, sr, wav)
        return
    wav = np.asarray(wav, np.float32)
    if norm:
        wav = wav / max(1e-8, np.abs(wav).max()) * 0.95
    wav = np.clip(wav, -1.0, 1.0)
    wavfile.write(path, sr, (wav * 32767).astype(np.int16))
