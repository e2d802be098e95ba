"""Host-side DSP constants: the STFT window and the slaney mel filterbank.

numpy only, computed in float64 and cast at the end, with the conventions
of librosa's defaults (periodic Hann window zero-centred to ``n_fft``,
slaney mel scale with slaney area normalisation).
"""

from __future__ import annotations

import numpy as np


def stft_window(window: str, win_length: int, n_fft: int) -> np.ndarray:
    """Periodic window, zero-padded symmetrically to n_fft (librosa layout)."""
    if window != "hann":
        raise NotImplementedError(f"window={window!r}")
    n = np.arange(win_length, dtype=np.float64)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        w = np.pad(w, (lpad, n_fft - win_length - lpad))
    return w


def hz_to_mel(freqs):
    """Slaney mel scale: linear below 1 kHz, logarithmic above."""
    freqs = np.asanyarray(freqs, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        freqs >= min_log_hz,
        min_log_mel + np.log(np.maximum(freqs, min_log_hz) / min_log_hz) / logstep,
        freqs / f_sp)


def mel_to_hz(mels):
    """Inverse of :func:`hz_to_mel`."""
    mels = np.asanyarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(mels >= min_log_mel,
                    min_log_hz * np.exp(logstep * (mels - min_log_mel)),
                    f_sp * mels)


def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int = 80,
                   fmin: float = 0.0, fmax: float | None = None) -> np.ndarray:
    """Triangular slaney mel filterbank [n_mels, 1 + n_fft//2] with slaney
    area normalisation, float32."""
    fmax = fmax if fmax is not None else sample_rate / 2.0
    n_bins = 1 + n_fft // 2
    fftfreqs = np.linspace(0.0, sample_rate / 2.0, n_bins)
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1][:, None]
    upper = ramps[2:] / fdiff[1:][:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels])
    return (weights * enorm[:, None]).astype(np.float32)
