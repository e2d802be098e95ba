"""PESQ wrapper (narrowband @16k over [G_SEG]/[P_SEG] pairs).

Parity surface: ``eval/pesq_metric.py`` (:36: pesq 'nb' at 16 kHz). PESQ is
an ITU C implementation; we call the ``pesq`` PyPI package when installed
and raise an actionable error otherwise (no pure-python rewrite exists that
matches the standard).

The port's copy of the JAX package's ``evals/pesq_metric.py``.
"""

from __future__ import annotations

import numpy as np

from speech_editing_tpu_torch.evals.mcd import seg_pairs
from speech_editing_tpu_torch.utils.audio.io import load_wav

PESQ_SR = 16000


_warned_fallback = False


def cal_pesq(ref: np.ndarray, est: np.ndarray, sr: int = PESQ_SR,
             mode: str = "nb") -> float:
    """ITU C implementation when the ``pesq`` package is installed
    (preferred, exact); else the vendored numpy P.862 model
    (``evals.pesq_np`` — approximate, see its docstring)."""
    try:
        from pesq import pesq as _pesq  # type: ignore

        return float(_pesq(sr, ref, est, mode))
    except ImportError:
        pass
    global _warned_fallback
    if not _warned_fallback:
        print("| PESQ: 'pesq' package not installed (pip install pesq); "
              "using the vendored numpy P.862 model (approximate scores)")
        _warned_fallback = True
    if mode != "nb":
        raise ValueError("numpy PESQ fallback implements 'nb' only")
    from speech_editing_tpu_torch.evals.pesq_np import pesq_np

    return pesq_np(sr, ref, est)


def cal_pesq_with_waves_batch(waves_dir_glob: str, mode: str = "nb") -> float:
    pairs = seg_pairs(waves_dir_glob)
    assert pairs, f"no [G_SEG] wavs under {waves_dir_glob}"
    vals = []
    for ref_fn, est_fn in pairs:
        ref, _ = load_wav(ref_fn, PESQ_SR)
        est, _ = load_wav(est_fn, PESQ_SR)
        t = min(len(ref), len(est))
        try:
            vals.append(cal_pesq(ref[:t], est[:t], PESQ_SR, mode))
        except Exception as e:  # per-item PESQ failures (too short etc.)
            print(f"| PESQ skipped {est_fn}: {e}")
    return float(np.mean(vals)) if vals else float("nan")
