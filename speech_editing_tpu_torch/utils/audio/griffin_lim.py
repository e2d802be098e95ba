"""Griffin-Lim phase reconstruction (the vocoder fallback, host numpy): the
port's copy of the JAX package's ``utils/audio/griffin_lim.py``. The
initial phases come from ``RandomState(0)``, so a mel always gives the
same wav."""

from __future__ import annotations

import numpy as np

from speech_editing_tpu_torch.utils.audio.dsp import istft, mel_filterbank, stft


def griffin_lim(magnitude: np.ndarray, n_fft: int = 1024, hop_size: int = 256,
                win_length: int | None = None, n_iters: int = 30) -> np.ndarray:
    """magnitude: [n_bins, T] linear amplitude spectrogram."""
    rng = np.random.RandomState(0)
    angles = np.exp(2j * np.pi * rng.rand(*magnitude.shape))
    spec = magnitude.astype(np.complex128) * angles
    for _ in range(n_iters):
        wav = istft(spec, hop_size, win_length)
        rebuilt = stft(wav, n_fft, hop_size, win_length)
        rebuilt = rebuilt[:, : magnitude.shape[1]]
        if rebuilt.shape[1] < magnitude.shape[1]:
            rebuilt = np.pad(rebuilt, ((0, 0), (0, magnitude.shape[1] - rebuilt.shape[1])))
        angles = np.exp(1j * np.angle(rebuilt))
        spec = magnitude * angles
    return istft(spec, hop_size, win_length).astype(np.float32)


def mel2wav_griffin_lim(log10_mel: np.ndarray, sample_rate: int = 22050,
                        n_fft: int = 1024, hop_size: int = 256,
                        num_mels: int = 80, fmin: float = 55, fmax: float = 7600,
                        eps: float = 1e-6, n_iters: int = 30) -> np.ndarray:
    """Invert a [T, n_mels] log10-mel via the filterbank's pseudo-inverse and
    Griffin-Lim; the wav has exactly ``T * hop_size`` samples."""
    mel_amp = np.power(10.0, log10_mel.T)  # [n_mels, T]
    basis = mel_filterbank(sample_rate, n_fft, num_mels, fmin, fmax)
    inv = np.linalg.pinv(basis)
    linear = np.maximum(eps, inv @ mel_amp)
    wav = griffin_lim(linear, n_fft, hop_size)
    want = log10_mel.shape[0] * hop_size
    if len(wav) < want:
        wav = np.pad(wav, (0, want - len(wav)))
    return wav[:want]
