"""Batch MCD/STOI/PESQ over a generated-wavs directory.

Parity surface: ``eval/get_metrics.py`` — the de-facto acceptance test:
pairs ``[G_SEG]`` (ground-truth segment) with ``[P_SEG]`` (predicted
segment) wavs from a test run's ``generated_*/wavs`` directory.

Usage: python -m speech_editing_tpu_torch.evals.get_metrics 'checkpoints/<exp>/generated_*/wavs/*'

The port's copy of the JAX package's ``evals/get_metrics.py``.
"""

from __future__ import annotations

import sys

from speech_editing_tpu_torch.evals.mcd import cal_mcd_with_wave_batch
from speech_editing_tpu_torch.evals.stoi import cal_stoi_with_waves_batch


def compute_all(waves_dir_glob: str, with_pesq: bool = True) -> dict:
    out = {
        "mcd": cal_mcd_with_wave_batch(waves_dir_glob),
        "stoi": cal_stoi_with_waves_batch(waves_dir_glob),
    }
    if with_pesq:
        try:
            from speech_editing_tpu_torch.evals.pesq_metric import \
                cal_pesq_with_waves_batch

            out["pesq"] = cal_pesq_with_waves_batch(waves_dir_glob)
        except ImportError as e:
            print(f"| PESQ unavailable: {e}")
            out["pesq"] = float("nan")
    return out


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    glob_pat = argv[0] if argv else "checkpoints/*/generated_*/wavs/*"
    m = compute_all(glob_pat)
    print(f"MCD = {m['mcd']}; STOI = {m['stoi']}; PESQ = {m['pesq']}.")
    return m


if __name__ == "__main__":
    main()
