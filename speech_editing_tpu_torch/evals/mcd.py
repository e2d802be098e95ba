"""Mel-cepstral distortion: wav-level (MFCC-34) and mel-level (Kubichek).

Parity surface:

* :func:`cal_mcd` / :func:`cal_mcd_with_wave_batch` — ``eval/mcd.py``:
  34-coeff HTK-mel MFCCs at the training audio params, mean frame-distance
  formula, batch over ``[G_SEG]``/``[P_SEG]`` wav pairs (:26-67);
* :func:`get_metrics_mels` — ``utils/eval/mcd.py``: Kubichek MCD over
  log10-mel MFCCs (zeroth coefficient dropped, DCT-II scaled by 1/2),
  optional DTW alignment + length penalty.

librosa/fastdtw-free: MFCCs come from the port's numpy DSP, DTW from evals.dtw.

The port's copy of the JAX package's ``evals/mcd.py``.
"""

from __future__ import annotations

import glob as globlib
from typing import Tuple

import numpy as np
from scipy.fftpack import dct

from speech_editing_tpu_torch.evals.dtw import dtw_path
from speech_editing_tpu_torch.utils.audio.dsp import mel_filterbank, stft
from speech_editing_tpu_torch.utils.audio.io import load_wav

TRAIN_CFG = dict(sample_rate=22050, n_fft=1024, win_length=1024,
                 hop_size=256, fmin=55, fmax=7600, n_mels=80)


def wav_mfcc(wav: np.ndarray, n_mfcc: int = 34, cfg: dict = TRAIN_CFG
             ) -> np.ndarray:
    """librosa.feature.mfcc(htk=True) equivalent: power mel -> dB -> DCT-II
    ortho, [n_mfcc, T]."""
    spec = np.abs(stft(wav, cfg["n_fft"], cfg["hop_size"], cfg["win_length"])) ** 2
    fb = mel_filterbank(cfg["sample_rate"], cfg["n_fft"], cfg["n_mels"],
                        cfg["fmin"], cfg["fmax"], htk=True)
    mel = fb @ spec
    log_mel = 10.0 * np.log10(np.maximum(mel, 1e-10))
    log_mel = np.maximum(log_mel, log_mel.max() - 80.0)  # librosa top_db
    return dct(log_mel, type=2, axis=0, norm="ortho")[:n_mfcc]


def cal_mcd(wav_pair: Tuple[str, str], use_dtw: bool = False) -> float:
    """MCD between two wav files (ref first), reference eval/mcd.py:26-49.

    DELIBERATE DEVIATION in the ``use_dtw`` branch: we align frames over
    the TIME axis (mfcc.T), whereas the reference runs fastdtw over the
    raw [n_mfcc, T] array — i.e. it aligns the 34 coefficient rows, which
    is not a meaningful temporal alignment. MCD-DTW numbers are therefore
    not directly comparable to values computed with the reference script;
    the non-DTW branch matches the reference exactly.
    """
    ref_fn, est_fn = wav_pair
    ref, _ = load_wav(ref_fn, TRAIN_CFG["sample_rate"])
    est, _ = load_wav(est_fn, TRAIN_CFG["sample_rate"])
    ref_mfcc = wav_mfcc(ref)
    est_mfcc = wav_mfcc(est)
    t = min(ref_mfcc.shape[1], est_mfcc.shape[1])
    if use_dtw:
        _, path = dtw_path(ref_mfcc.T, est_mfcc.T)
        x = ref_mfcc.T[[p[0] for p in path]]
        y = est_mfcc.T[[p[1] for p in path]]
        z = x - y
        return float(np.sqrt((z * z).sum(-1)).mean())
    ref_mfcc, est_mfcc = ref_mfcc[:, :t], est_mfcc[:, :t]
    diff2sum = np.sum((est_mfcc - ref_mfcc) ** 2, axis=1)
    return float(np.mean(10.0 / np.log(10.0) * np.sqrt(2 * diff2sum), axis=0)
                 / ref_mfcc.shape[1])


def seg_pairs(waves_dir_glob: str):
    pairs = []
    for item in sorted(globlib.glob(waves_dir_glob)):
        if "[G_SEG]" in item:
            pairs.append((item, item.replace("G_SEG", "P_SEG")))
    return pairs


def cal_mcd_with_wave_batch(waves_dir_glob: str, use_dtw: bool = False) -> float:
    pairs = seg_pairs(waves_dir_glob)
    assert pairs, f"no [G_SEG] wavs under {waves_dir_glob}"
    return float(np.mean([cal_mcd(p, use_dtw) for p in pairs]))


# -- mel-level Kubichek MCD (utils/eval/mcd.py) ------------------------------

def mel_mfcc_kubichek(mel_t: np.ndarray, n_mfcc: int = 16,
                      take_log: bool = False) -> np.ndarray:
    """mel [n_mels, T] -> MFCCs [n_mfcc, T], zeroth dropped, /2 scaling."""
    m = np.log10(np.maximum(mel_t, 1e-10)) if take_log else mel_t
    coeffs = dct(m, type=2, axis=0, norm=None)[: n_mfcc + 1]
    return coeffs[1:] / 2.0


def get_metrics_mels(mel1: np.ndarray, mel2: np.ndarray, n_mfcc: int = 16,
                     take_log: bool = False, use_dtw: bool = True
                     ) -> Tuple[float, float, int]:
    """(mcd, penalty, frames) over [T, n_mels] mel pairs
    (reference utils/eval/mcd.py:13-54)."""
    m1 = mel_mfcc_kubichek(np.asarray(mel1).T, n_mfcc, take_log)
    m2 = mel_mfcc_kubichek(np.asarray(mel2).T, n_mfcc, take_log)
    f1, f2 = m1.shape[1], m2.shape[1]
    if use_dtw:
        _, path = dtw_path(m1.T, m2.T)
        x = m1.T[[p[0] for p in path]]
        y = m2.T[[p[1] for p in path]]
        frames = len(path)
    else:
        frames = max(f1, f2)
        x = np.pad(m1, ((0, 0), (0, frames - f1))).T
        y = np.pad(m2, ((0, 0), (0, frames - f2))).T
        # fall through with zero-filled tails
    z = x - y
    mcd = float(np.sqrt((z * z).sum(-1)).mean())
    penalty = float(2 * frames - f1 - f2) / frames if frames else 0.0
    return mcd, penalty, frames
