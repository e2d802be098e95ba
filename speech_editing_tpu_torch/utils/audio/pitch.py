"""f0 quantisation and de-normalisation on torch tensors; on host numpy,
the dataset's f0 normalisation and the pitch-tracker registry with the
autocorrelation tracker the region-edit API runs (the port's copy of the
JAX package's ``extract_pitch`` and ``autocorr_pitch``; its native C++
tracker is not ported)."""

from __future__ import annotations

import math

import numpy as np
import torch

from speech_editing_tpu_torch.utils.dtypes import weak


def f0_to_coarse(f0: torch.Tensor, f0_bin: int = 256, f0_max: float = 900.0,
                 f0_min: float = 50.0) -> torch.Tensor:
    """Quantize Hz f0 to coarse bins 1..255 (0 Hz -> bin 1), int64.

    ``torch.round`` rounds half to even, like ``numpy.rint``.
    """
    f0_mel_min = 1127 * math.log(1 + f0_min / 700)
    f0_mel_max = 1127 * math.log(1 + f0_max / 700)
    # as the JAX package computes it in bf16: f0_mel in the input's dtype,
    # with the scalars rounded to it; the scaling in float32 (its constants
    # are numpy float32 there, which promote)
    f0_mel = weak(1127, f0) * torch.log(1 + f0 / weak(700, f0))
    scaled = (f0_mel.float() - f0_mel_min) * (f0_bin - 2) / (f0_mel_max - f0_mel_min) + 1
    f0_mel = torch.where(f0_mel > 0, scaled, f0_mel.float())
    return torch.round(f0_mel.clamp(1, f0_bin - 1)).long()


def f0_to_coarse_host(f0: np.ndarray, f0_bin: int = 256, f0_max: float = 900.0,
                     f0_min: float = 50.0) -> np.ndarray:
    """Host numpy, for the binarizer: :func:`f0_to_coarse` as int32 (the
    JAX package's numpy branch)."""
    f0_mel_min = 1127 * np.log(1 + f0_min / 700)
    f0_mel_max = 1127 * np.log(1 + f0_max / 700)
    f0_mel = 1127 * np.log(1 + f0 / 700)
    scaled = (f0_mel - f0_mel_min) * (f0_bin - 2) / (f0_mel_max - f0_mel_min) + 1
    f0_mel = np.where(f0_mel > 0, scaled, f0_mel)
    return np.rint(np.clip(f0_mel, 1, f0_bin - 1)).astype(np.int32)


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


PITCH_EXTRACTORS = {}


def register_pitch_extractor(name):
    def wrap(fn):
        PITCH_EXTRACTORS[name] = fn
        return fn

    return wrap


def extract_pitch(extractor_name, wav, hop_size, audio_sample_rate,
                  f0_min=75, f0_max=800, **kw) -> np.ndarray:
    """f0 [len(wav) // hop_size] in Hz, 0 where unvoiced, from the named
    tracker; ``parselmouth``, ``praat`` and ``ac`` name the autocorrelation
    tracker."""
    if extractor_name in ("parselmouth", "praat", "ac"):
        extractor_name = "autocorr"
    return PITCH_EXTRACTORS[extractor_name](wav, hop_size, audio_sample_rate,
                                            f0_min, f0_max, **kw)


@register_pitch_extractor("autocorr_native")
def autocorr_pitch_native(wav, hop_size, audio_sample_rate, f0_min=75, f0_max=800,
                          voicing_threshold=0.45, **kw) -> np.ndarray:
    """The JAX package's threaded C++ tracker's key: the port has no native
    library, so this is :func:`autocorr_pitch`, as the JAX package falls
    back to it when its library is not built."""
    return autocorr_pitch(wav, hop_size, audio_sample_rate, f0_min, f0_max,
                          voicing_threshold, **kw)


@register_pitch_extractor("autocorr")
def autocorr_pitch(wav, hop_size, audio_sample_rate, f0_min=75, f0_max=800,
                   voicing_threshold=0.45, **kw) -> np.ndarray:
    """Normalized-autocorrelation f0 tracker (Boersma 1993 flavor): one f0
    value per mel frame (``len(wav) // hop_size`` values), 0 for unvoiced
    frames."""
    wav = np.asarray(wav, np.float64)
    n_frames = int(len(wav) // hop_size)
    if n_frames == 0:
        return np.zeros(0, np.float32)

    win = int(round(3.0 / f0_min * audio_sample_rate))  # 3 periods of f0_min
    win = min(win, len(wav))
    half = win // 2
    lag_min = max(2, int(audio_sample_rate / f0_max))
    lag_max = min(win - 2, int(audio_sample_rate / f0_min))
    if lag_max <= lag_min:
        return np.zeros(n_frames, np.float32)

    # centred frames, zero-padded at the edges
    pad = half + 1
    wav_p = np.pad(wav, (pad, pad + win), mode="constant")
    centers = (np.arange(n_frames) * hop_size + hop_size // 2) + pad
    idx = centers[:, None] + np.arange(-half, win - half)[None, :]
    frames = wav_p[idx]
    frames = frames - frames.mean(axis=1, keepdims=True)

    w = np.hanning(win)
    fw = frames * w[None, :]
    # autocorrelation via FFT, normalized by the window's autocorrelation
    nfft = int(2 ** np.ceil(np.log2(2 * win)))
    spec = np.fft.rfft(fw, nfft, axis=1)
    ac = np.fft.irfft(spec * np.conj(spec), nfft, axis=1)[:, : lag_max + 2]
    wspec = np.fft.rfft(w, nfft)
    wac = np.fft.irfft(wspec * np.conj(wspec), nfft)[: lag_max + 2]
    ac0 = np.maximum(ac[:, :1], 1e-12)
    r = (ac / ac0) / np.maximum(wac / wac[0], 1e-6)[None, :]

    seg = r[:, lag_min: lag_max + 1]
    best = np.argmax(seg, axis=1) + lag_min
    # parabolic interpolation around the peak
    r_m1 = r[np.arange(n_frames), best - 1]
    r_0 = r[np.arange(n_frames), best]
    r_p1 = r[np.arange(n_frames), best + 1]
    denom = (r_m1 - 2 * r_0 + r_p1)
    delta = np.where(np.abs(denom) > 1e-9, 0.5 * (r_m1 - r_p1) / denom, 0.0)
    delta = np.clip(delta, -1, 1)
    lag = best + delta
    f0 = audio_sample_rate / np.maximum(lag, 1e-6)

    # voicing decision: peak strength and a minimum energy
    rms = np.sqrt((frames ** 2).mean(axis=1))
    voiced = (r_0 > voicing_threshold) & (rms > 1e-4 + 0.02 * np.median(rms))
    f0 = np.where(voiced & (f0 >= f0_min) & (f0 <= f0_max), f0, 0.0)

    # median smoothing against octave glitches
    if n_frames >= 3:
        f0_med = np.stack([np.roll(f0, -1), f0, np.roll(f0, 1)]).T
        f0_smooth = np.median(f0_med, axis=1)
        f0 = np.where(f0 > 0, np.where(f0_smooth > 0, f0_smooth, f0), 0.0)
    return f0.astype(np.float32)
