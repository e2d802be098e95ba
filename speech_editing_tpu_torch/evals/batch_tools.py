"""Batch evaluation CLIs rounding out the reference ``eval/`` directory.

Parity surfaces:

* :func:`cal_mcd_sptk_batch` — ``eval/a3t_mcd.py``: mel-cepstrum (mcep)
  MCD over DTW-aligned frames, pairing generated wavs with ground-truth
  by ``[G_SEG]``/``[P_SEG]`` tags (or basename when two dirs are given).
  pysptk-free: mcep comes from the real cepstrum frequency-warped with
  the standard all-pass ``freqt`` recursion (alpha matched to the sample
  rate like ``a3t_mcd.py::_get_best_mcep_params``).
* :func:`pitch_comparison_batch` — ``eval/pitch_com.py``: frame-wise f0
  MSE over ``[G_SEG]``/``[P_SEG]`` pairs (no DTW, like the reference),
  f0 from the port's autocorrelation tracker instead of parselmouth.
* :func:`meta_csv_stats` — ``eval/dur_com.py``: column means of a test
  run's ``meta.csv``.
* :func:`separate_wavs` — ``eval/seperate.py``: split a ``wavs/`` dir
  into ``gt/`` (``[G]``) and ``gen/`` (``[P]``) subdirectories.

Usage::

    python -m speech_editing_tpu_torch.evals.batch_tools mcd   'ckpt/*/generated_*/wavs/*'
    python -m speech_editing_tpu_torch.evals.batch_tools pitch 'ckpt/*/generated_*/wavs/*'
    python -m speech_editing_tpu_torch.evals.batch_tools stats  ckpt/<exp>/generated_*/meta.csv
    python -m speech_editing_tpu_torch.evals.batch_tools separate ckpt/<exp>/generated_*

The port's copy of the JAX package's ``evals/batch_tools.py``.
"""

from __future__ import annotations

import argparse
import csv
import glob as globlib
import os
import shutil
from typing import List, Optional, Tuple

import numpy as np

from speech_editing_tpu_torch.evals.dtw import dtw_path
from speech_editing_tpu_torch.evals.mcd import seg_pairs
from speech_editing_tpu_torch.utils.audio.io import load_wav
from speech_editing_tpu_torch.utils.audio.pitch import extract_pitch

_LOG10_E10 = 10.0 / np.log(10.0)


def best_mcep_params(fs: int) -> Tuple[int, float]:
    """(order, alpha) per sample rate (a3t_mcd.py::_get_best_mcep_params)."""
    table = {16000: (23, 0.42), 22050: (34, 0.45), 24000: (34, 0.46),
             44100: (39, 0.53), 48000: (39, 0.55)}
    if fs not in table:
        raise ValueError(f"no mcep setting for sample rate {fs}")
    return table[fs]


def freqt(c: np.ndarray, order: int, alpha: float) -> np.ndarray:
    """All-pass frequency transform of a cepstrum (SPTK freqt recursion),
    over the last axis: ``c [..., n] -> [..., order + 1]``. Each element
    takes the operations of the JAX package's one-frame loop in its order,
    so a batch of frames gives its results bit for bit."""
    c = np.asarray(c, np.float64)
    g = np.zeros(c.shape[:-1] + (order + 1,), np.float64)
    for i in range(c.shape[-1] - 1, -1, -1):
        d = g.copy()
        g[..., 0] = c[..., i] + alpha * d[..., 0]
        if order >= 1:
            g[..., 1] = (1.0 - alpha * alpha) * d[..., 0] + alpha * d[..., 1]
        for m in range(2, order + 1):
            g[..., m] = d[..., m - 1] + alpha * (d[..., m] - g[..., m - 1])
    return g


def mcep_from_wav(wav: np.ndarray, fs: int, n_fft: int = 512,
                  n_shift: int = 256, mcep_dim: Optional[int] = None,
                  mcep_alpha: Optional[float] = None) -> np.ndarray:
    """Framewise mel-cepstrum [n_frames, mcep_dim+1] (a3t_mcd.py::sptk_extract
    role): hamming window -> log magnitude -> real cepstrum -> freqt warp."""
    if mcep_dim is None or mcep_alpha is None:
        mcep_dim, mcep_alpha = best_mcep_params(fs)
    x = np.asarray(wav, np.float64)
    n_frame = max((len(x) - n_fft) // n_shift + 1, 0)
    if n_frame == 0:
        x = np.pad(x, (0, n_fft - len(x)))
        n_frame = 1
    win = np.hamming(n_fft)
    idx = n_shift * np.arange(n_frame)[:, None] + np.arange(n_fft)[None, :]
    frames = x[idx] * win
    mag = np.abs(np.fft.rfft(frames, n_fft, axis=-1))
    # real cepstrum (symmetric log-spectrum IDFT), first half is enough
    cep = np.fft.irfft(np.log(np.maximum(mag, 1e-6)), n_fft, axis=-1)
    half = n_fft // 2 + 1
    cep = cep[:, :half].copy()
    cep[:, 1:-1] *= 2.0  # fold the symmetric tail (c0/Nyquist not mirrored)
    return freqt(cep, mcep_dim, mcep_alpha)


def cal_mcd_sptk(wav_pair: Tuple[str, str], n_fft: int = 512,
                 n_shift: int = 256) -> float:
    """mcep MCD between (ground-truth, generated) wav files, DTW-aligned,
    power coefficient c0 excluded (a3t_mcd.py::calculate)."""
    gt, _ = load_wav(wav_pair[0], None)
    gen, sr = load_wav(wav_pair[1], None)
    gt_m = mcep_from_wav(gt, sr, n_fft, n_shift)[:, 1:]
    gen_m = mcep_from_wav(gen, sr, n_fft, n_shift)[:, 1:]
    _, path = dtw_path(gt_m, gen_m)
    diff = gt_m[[p[0] for p in path]] - gen_m[[p[1] for p in path]]
    return float(_LOG10_E10 * np.mean(np.sqrt(2.0 * (diff * diff).sum(-1))))


def cal_mcd_sptk_batch(waves_dir_glob: str) -> float:
    pairs = seg_pairs(waves_dir_glob)
    assert pairs, f"no [G_SEG] wavs under {waves_dir_glob}"
    return float(np.mean([cal_mcd_sptk(p) for p in pairs]))


def pitch_comparison_batch(waves_dir_glob: str, hop_size: int = 256,
                           f0_min: float = 80.0, f0_max: float = 600.0
                           ) -> float:
    """Mean frame-wise f0 MSE over [G_SEG]/[P_SEG] pairs (eval/pitch_com.py)."""
    pairs = seg_pairs(waves_dir_glob)
    assert pairs, f"no [G_SEG] wavs under {waves_dir_glob}"
    mses = []
    for gt_fn, gen_fn in pairs:
        def _f0(fn):
            wav, sr = load_wav(fn, None)
            return extract_pitch("autocorr", wav, hop_size, sr,
                                 f0_min=f0_min, f0_max=f0_max)
        a, b = _f0(gt_fn), _f0(gen_fn)
        t = min(len(a), len(b))
        if t == 0:
            continue
        mses.append(float(np.mean((a[:t] - b[:t]) ** 2)))
    return float(np.mean(mses)) if mses else float("nan")


def pitch_dtw_batch(waves_dir_glob: str, hop_size: int = 256) -> float:
    """DTW-aligned f0 distance over pairs (utils/metrics/pitch_distance.py
    applied batch-wise)."""
    from speech_editing_tpu_torch.evals.attention_metrics import pitch_dtw_distance

    pairs = seg_pairs(waves_dir_glob)
    assert pairs, f"no [G_SEG] wavs under {waves_dir_glob}"
    out = []
    for gt_fn, gen_fn in pairs:
        wa, sr = load_wav(gt_fn, None)
        wb, _ = load_wav(gen_fn, None)
        fa = extract_pitch("autocorr", wa, hop_size, sr)
        fb = extract_pitch("autocorr", wb, hop_size, sr)
        out.append(pitch_dtw_distance(fa, fb))
    return float(np.mean(out))


def meta_csv_stats(meta_csv: str, columns: Optional[List[str]] = None) -> dict:
    """Column means of a test run's meta.csv (eval/dur_com.py role)."""
    with open(meta_csv) as f:
        rows = list(csv.DictReader(f))
    assert rows, f"empty meta csv {meta_csv}"
    stats = {}
    for col in (columns or rows[0].keys()):
        vals = []
        for r in rows:
            try:
                vals.append(float(r[col]))
            except (ValueError, TypeError, KeyError):
                break
        else:
            if vals:
                stats[col] = float(np.mean(vals))
    return stats


def separate_wavs(gen_dir: str) -> Tuple[str, str]:
    """Copy [G]*.wav -> gt/, [P]*.wav -> gen/ (eval/seperate.py role)."""
    gt_dir = os.path.join(gen_dir, "gt")
    out_dir = os.path.join(gen_dir, "gen")
    os.makedirs(gt_dir, exist_ok=True)
    os.makedirs(out_dir, exist_ok=True)
    for wav in sorted(globlib.glob(os.path.join(gen_dir, "wavs", "*.wav"))):
        name = os.path.basename(wav)
        if "[P]" in name:
            shutil.copyfile(wav, os.path.join(out_dir, name))
        elif "[G]" in name:
            shutil.copyfile(wav, os.path.join(gt_dir, name))
    return gt_dir, out_dir


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("mcd");   p.add_argument("waves_glob")
    p = sub.add_parser("pitch"); p.add_argument("waves_glob")
    p.add_argument("--dtw", action="store_true")
    p = sub.add_parser("stats"); p.add_argument("meta_csv")
    p.add_argument("--columns", nargs="*", default=None)
    p = sub.add_parser("separate"); p.add_argument("gen_dir")
    a = ap.parse_args(argv)
    if a.cmd == "mcd":
        print(f"mcep MCD = {cal_mcd_sptk_batch(a.waves_glob):.4f}")
    elif a.cmd == "pitch":
        fn = pitch_dtw_batch if a.dtw else pitch_comparison_batch
        print(f"pitch distance = {fn(a.waves_glob):.4f}")
    elif a.cmd == "stats":
        for k, v in meta_csv_stats(a.meta_csv, a.columns).items():
            print(f"{k} = {v:.6f}")
    elif a.cmd == "separate":
        gt, gen = separate_wavs(a.gen_dir)
        print(f"wrote {gt} and {gen}")


if __name__ == "__main__":
    main()
