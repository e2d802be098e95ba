"""STOI — short-time objective intelligibility (numpy, pystoi-free).

Parity surface: the vendored implementation at ``eval/stoi.py`` /
``utils/eval/stoi.py`` (Taal et al. 2010): resample to 10 kHz, drop silent
frames (40 dB range), 512-pt STFT (256 win / 128 hop), 15 one-third-octave
bands from 150 Hz, 30-frame segments with normalisation + (-15 dB) clipping,
averaged band/segment correlation. Batch driver pairs ``[G_SEG]``/``[P_SEG]``
wavs like ``eval/get_metrics.py``.

The port's copy of the JAX package's ``evals/stoi.py``.
"""

from __future__ import annotations

import numpy as np
from scipy.signal import resample_poly

from speech_editing_tpu_torch.evals.mcd import seg_pairs
from speech_editing_tpu_torch.utils.audio.io import load_wav

FS = 10000
N_FRAME = 256
NFFT = 512
NUMBAND = 15
MINFREQ = 150
N = 30  # segment length in frames
BETA = -15.0
DYN_RANGE = 40


def _thirdoct(fs: int = FS, nfft: int = NFFT, num_bands: int = NUMBAND,
              min_freq: float = MINFREQ):
    f = np.linspace(0, fs, nfft + 1)[: nfft // 2 + 1]
    k = np.arange(num_bands)
    cf = min_freq * 2.0 ** (k / 3.0)
    fl = cf * 2 ** (-1.0 / 6)
    fr = cf * 2 ** (1.0 / 6)
    obm = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        fl_i = np.argmin(np.square(f - fl[i]))
        fr_i = np.argmin(np.square(f - fr[i]))
        obm[i, fl_i:fr_i] = 1
    return obm


def _stft_frames(x: np.ndarray):
    w = np.hanning(N_FRAME + 2)[1:-1]
    hop = N_FRAME // 2
    n_frames = max(0, (len(x) - N_FRAME) // hop + 1)
    frames = np.stack([x[i * hop: i * hop + N_FRAME] * w
                       for i in range(n_frames)]) if n_frames else np.zeros((0, N_FRAME))
    return np.fft.rfft(frames, n=NFFT, axis=-1)


def _remove_silent_frames(x: np.ndarray, y: np.ndarray):
    hop = N_FRAME // 2
    w = np.hanning(N_FRAME + 2)[1:-1]
    n_frames = max(0, (len(x) - N_FRAME) // hop + 1)
    if n_frames == 0:
        return x, y
    frames_x = np.stack([x[i * hop: i * hop + N_FRAME] * w for i in range(n_frames)])
    energies = 20 * np.log10(np.linalg.norm(frames_x, axis=1) + 1e-12)
    mask = energies > (energies.max() - DYN_RANGE)
    xs, ys = np.zeros_like(x), np.zeros_like(y)
    pos = 0
    for i in range(n_frames):
        if mask[i]:
            xs[pos: pos + N_FRAME] += x[i * hop: i * hop + N_FRAME] * w
            ys[pos: pos + N_FRAME] += y[i * hop: i * hop + N_FRAME] * w
            pos += hop
    return xs[: pos + N_FRAME - hop], ys[: pos + N_FRAME - hop]


def stoi(x: np.ndarray, y: np.ndarray, fs: int) -> float:
    """Intelligibility of degraded y vs clean x, in [0, 1]-ish."""
    if fs != FS:
        g = np.gcd(int(fs), FS)
        x = resample_poly(x, FS // g, fs // g)
        y = resample_poly(y, FS // g, fs // g)
    x, y = _remove_silent_frames(x, y)
    spec_x = np.abs(_stft_frames(x)) ** 2
    spec_y = np.abs(_stft_frames(y)) ** 2
    if spec_x.shape[0] < N:
        return float("nan")
    obm = _thirdoct()
    bx = np.sqrt(spec_x @ obm.T)  # [T, bands]
    by = np.sqrt(spec_y @ obm.T)

    d_sum, seg_count = 0.0, 0
    for m in range(N, bx.shape[0] + 1):
        seg_x = bx[m - N: m]  # [N, bands]
        seg_y = by[m - N: m]
        alpha = np.sqrt(np.sum(seg_x ** 2, axis=0)
                        / np.maximum(np.sum(seg_y ** 2, axis=0), 1e-12))
        ay = seg_y * alpha[None, :]
        y_clip = np.minimum(ay, seg_x * (1 + 10 ** (-BETA / 20.0)))
        xn = seg_x - seg_x.mean(axis=0, keepdims=True)
        yn = y_clip - y_clip.mean(axis=0, keepdims=True)
        denom = (np.linalg.norm(xn, axis=0) * np.linalg.norm(yn, axis=0))
        corr = np.sum(xn * yn, axis=0) / np.maximum(denom, 1e-12)
        d_sum += corr.mean()
        seg_count += 1
    return float(d_sum / max(seg_count, 1))


def cal_stoi_with_waves_batch(waves_dir_glob: str,
                              sample_rate: int = 22050) -> float:
    pairs = seg_pairs(waves_dir_glob)
    assert pairs, f"no [G_SEG] wavs under {waves_dir_glob}"
    vals = []
    for ref_fn, est_fn in pairs:
        ref, sr = load_wav(ref_fn, sample_rate)
        est, _ = load_wav(est_fn, sample_rate)
        t = min(len(ref), len(est))
        v = stoi(ref[:t], est[:t], sr)
        if np.isfinite(v):
            vals.append(v)
    return float(np.mean(vals)) if vals else float("nan")
