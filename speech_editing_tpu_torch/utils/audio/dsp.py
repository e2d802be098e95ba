"""Host-side DSP: the STFT window, the slaney mel filterbank, STFT and
inverse STFT, and the log-mel of a wav (``wav2spec``).

numpy only (scipy for the window), computed in float64 and cast at the
end, with the conventions of librosa's defaults (periodic Hann window
zero-centred to ``n_fft``, ``center=True`` constant padding, slaney mel
scale with slaney area normalisation, log10 mel with eps 1e-6). The port's
copy of the JAX package's ``utils/audio/dsp.py``, with its native backend
(``native.py``): the region-edit API's and the binarizer's log-mel is this
host function, as in the JAX package, not kernel K2.
"""

from __future__ import annotations

import numpy as np
from scipy.signal import get_window


def stft_window(window: str, win_length: int, n_fft: int) -> np.ndarray:
    """Periodic window, zero-padded symmetrically to n_fft (librosa layout)."""
    w = get_window(window, win_length, fftbins=True).astype(np.float64)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        w = np.pad(w, (lpad, n_fft - win_length - lpad))
    return w


def frame_signal(y: np.ndarray, n_fft: int, hop: int, center: bool = True,
                 pad_mode: str = "constant") -> np.ndarray:
    """Slice a 1-D signal into overlapping frames [n_frames, n_fft]."""
    if center:
        y = np.pad(y, (n_fft // 2, n_fft // 2), mode=pad_mode)
    n_frames = 1 + (len(y) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    return y[idx]


def stft(y: np.ndarray, n_fft: int = 1024, hop_size: int = 256,
         win_length: int | None = None, window: str = "hann",
         center: bool = True, pad_mode: str = "constant") -> np.ndarray:
    """Complex STFT, shape [1 + n_fft//2, n_frames] (librosa layout)."""
    win_length = win_length or n_fft
    w = stft_window(window, win_length, n_fft)
    frames = frame_signal(np.asarray(y, np.float64), n_fft, hop_size, center, pad_mode)
    spec = np.fft.rfft(frames * w[None, :], n=n_fft, axis=-1)
    return spec.T


def istft(spec: np.ndarray, hop_size: int = 256, win_length: int | None = None,
          window: str = "hann", center: bool = True, length: int | None = None) -> np.ndarray:
    """Inverse STFT by overlap-add with squared-window normalization; with
    ``center`` and no ``length`` both padded edges are trimmed, as librosa
    does."""
    n_fft = 2 * (spec.shape[0] - 1)
    win_length = win_length or n_fft
    w = stft_window(window, win_length, n_fft)
    frames = np.fft.irfft(spec.T, n=n_fft, axis=-1) * w[None, :]
    n_frames = frames.shape[0]
    out_len = n_fft + hop_size * (n_frames - 1)
    y = np.zeros(out_len)
    norm = np.zeros(out_len)
    w2 = w * w
    for i in range(n_frames):
        s = i * hop_size
        y[s:s + n_fft] += frames[i]
        norm[s:s + n_fft] += w2
    y = y / np.maximum(norm, 1e-10)
    if center:
        y = y[n_fft // 2:]
        if length is None:
            y = y[: max(out_len - n_fft, 0)]
    if length is not None:
        if len(y) < length:
            y = np.pad(y, (0, length - len(y)))
        y = y[:length]
    return y


def hz_to_mel(freqs, htk: bool = False):
    """Slaney mel scale: linear below 1 kHz, logarithmic above; or HTK's."""
    freqs = np.asanyarray(freqs, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + freqs / 700.0)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        freqs >= min_log_hz,
        min_log_mel + np.log(np.maximum(freqs, min_log_hz) / min_log_hz) / logstep,
        freqs / f_sp)


def mel_to_hz(mels, htk: bool = False):
    """Inverse of :func:`hz_to_mel`."""
    mels = np.asanyarray(mels, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(mels >= min_log_mel,
                    min_log_hz * np.exp(logstep * (mels - min_log_mel)),
                    f_sp * mels)


def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int = 80,
                   fmin: float = 0.0, fmax: float | None = None,
                   htk: bool = False) -> np.ndarray:
    """Triangular mel filterbank [n_mels, 1 + n_fft//2] on the slaney (or,
    with ``htk``, HTK's) mel scale with slaney area normalisation, float32."""
    fmax = fmax if fmax is not None else sample_rate / 2.0
    n_bins = 1 + n_fft // 2
    fftfreqs = np.linspace(0.0, sample_rate / 2.0, n_bins)
    mel_pts = np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts, htk)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1][:, None]
    upper = ramps[2:] / fdiff[1:][:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels])
    return (weights * enorm[:, None]).astype(np.float32)


def amp_to_db(x):
    return 20 * np.log10(np.maximum(1e-5, x))


def normalize_spec(s, min_level_db):
    return (s - min_level_db) / -min_level_db


def pad_lr(x: np.ndarray, fsize: int, fshift: int, pad_sides: int = 1):
    """Padding that lands the signal on an exact frame boundary."""
    assert pad_sides in (1, 2)
    pad = (x.shape[0] // fshift + 1) * fshift - x.shape[0]
    if pad_sides == 1:
        return 0, pad
    return pad // 2, pad // 2 + pad % 2


def wav2spec(wav_or_path, fft_size: int = 1024, hop_size: int = 256,
             win_length: int = 1024, window: str = "hann", num_mels: int = 80,
             fmin: float = 80, fmax: float = -1, eps: float = 1e-6,
             sample_rate: int = 22050, loud_norm: bool = False,
             trim_long_sil: bool = False, backend: str = "numpy") -> dict:
    """wav (or a wav file's path) -> ``{'wav': [N], 'mel': [T, n_mels],
    'linear': [T, n_bins], 'mel_basis': [n_mels, n_bins]}``: log10 mel and
    linear spectrogram, the wav zero-padded or cut to exactly ``T *
    hop_size`` samples. ``fmin``/``fmax`` of -1 mean 0 and Nyquist.
    ``trim_long_sil`` shortens the long silences of a wav read from a path
    first (``vad.trim_long_silences``). ``backend``: ``numpy`` computes
    here; ``native`` runs the threaded C++ library (``native.py``; hann
    windows and power-of-two FFT sizes) and raises where it cannot;
    ``auto`` runs it where it can, else numpy."""
    if isinstance(wav_or_path, str):
        from speech_editing_tpu_torch.utils.audio.io import load_wav

        wav, _ = load_wav(wav_or_path, sample_rate)
        if trim_long_sil:
            from speech_editing_tpu_torch.utils.audio.vad import trim_long_silences

            wav = trim_long_silences(wav, sample_rate)
    else:
        wav = np.asarray(wav_or_path, np.float32)
    if loud_norm:
        # RMS normalization to about -22 dB, as the JAX package approximates
        # BS.1770 loudness without pyloudnorm
        rms = np.sqrt(np.mean(wav ** 2) + 1e-12)
        wav = wav * (10 ** (-22 / 20) / max(rms, 1e-8))
        if np.abs(wav).max() > 1:
            wav = wav / np.abs(wav).max()
    fmin = 0 if fmin == -1 else fmin
    fmax = sample_rate / 2 if fmax == -1 else fmax
    mel_basis = mel_filterbank(sample_rate, fft_size, num_mels, fmin, fmax)
    use_native = False
    if backend in ("native", "auto"):
        eligible = window == "hann" and fft_size > 0 and (fft_size & (fft_size - 1)) == 0
        if eligible:
            from speech_editing_tpu_torch.utils.audio import native

            use_native = native.available()
        if backend == "native" and not use_native:
            raise RuntimeError(
                "backend='native' unavailable: "
                + (f"unsupported window/fft_size (window={window!r}, fft_size={fft_size})"
                   if not eligible else "library not built (g++ missing or the build failed)"))
    if use_native:
        mel, linear = native.stft_mel_native(
            wav, fft_size, hop_size, win_length, num_mels, fmin, fmax, eps=eps,
            sample_rate=sample_rate, want_linear=True,
            window=stft_window("hann", win_length, fft_size), mel_basis=mel_basis)
        mel, linear = mel.T, linear.astype(np.float64).T
    else:
        linear = np.abs(stft(wav, fft_size, hop_size, win_length, window, center=True,
                             pad_mode="constant"))  # [n_bins, T]
        mel = np.log10(np.maximum(eps, mel_basis @ linear))
    l_pad, r_pad = pad_lr(wav, fft_size, hop_size, 1)
    wav = np.pad(wav, (l_pad, r_pad), mode="constant")
    wav = wav[: mel.shape[1] * hop_size]
    linear = np.log10(np.maximum(eps, linear))
    return {"wav": wav.astype(np.float32), "mel": mel.T.astype(np.float32),
            "linear": linear.T.astype(np.float32), "mel_basis": mel_basis}
