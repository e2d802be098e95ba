"""Trimming of long silences for ``wav2spec(trim_long_sil=True)``: the
port's copy of the JAX package's ``utils/audio/vad.py``, a windowed-energy
voice activity detector with a moving-average smoother (webrtcvad, the
reference toolkit's detector, is not a dependency)."""

from __future__ import annotations

import numpy as np


def trim_long_silences(wav: np.ndarray, sample_rate: int, window_ms: int = 30,
                       smooth_width: int = 8, db_threshold: float = -45.0,
                       max_silence_ms: int = 400) -> np.ndarray:
    """``wav`` with each silence longer than ``max_silence_ms`` cut down to
    about that length (its middle dropped); the samples after the last
    whole window are kept."""
    wav = np.asarray(wav, np.float32)
    win = max(1, int(sample_rate * window_ms / 1000))
    n_win = len(wav) // win
    if n_win == 0:
        return wav
    frames = wav[: n_win * win].reshape(n_win, win)
    rms = np.sqrt(np.mean(frames ** 2, axis=1) + 1e-12)
    voiced = 20 * np.log10(np.maximum(rms, 1e-8)) > db_threshold
    kernel = np.ones(smooth_width) / smooth_width
    voiced = np.convolve(voiced.astype(np.float32), kernel, mode="same") > 0.35

    max_sil_win = max(1, int(max_silence_ms / window_ms))
    keep = np.ones(n_win, bool)
    run_start = None
    for i in range(n_win + 1):
        v = voiced[i] if i < n_win else True
        if not v and run_start is None:
            run_start = i
        elif v and run_start is not None:
            if i - run_start > max_sil_win:
                # keep max_sil_win windows of the silence, drop the rest
                keep[run_start + max_sil_win // 2: i - (max_sil_win - max_sil_win // 2)] = False
            run_start = None
    out = frames.reshape(-1)[np.repeat(keep, win)]
    return np.concatenate([out, wav[n_win * win:]])
