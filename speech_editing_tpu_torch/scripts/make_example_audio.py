"""Writes a synthetic demo wav for ``inference/example.csv``.

The CSV region-edit driver (``infer/spec_denoiser.py``) needs a source
recording; real use points ``wav_fn_orig`` at actual speech. This writes a
harmonic stand-in (a 140 Hz voice with a gentle vibrato and a
syllable-like envelope) so that the documented default path exists:

    python -m speech_editing_tpu_torch.scripts.make_example_audio [OUT.wav]
"""

from __future__ import annotations

import os
import sys

import numpy as np


def main(out: str = "inference/audio/demo_1.wav", sr: int = 22050,
         seconds: float = 2.0) -> str:
    from speech_editing_tpu_torch.utils.audio.io import save_wav

    t = np.arange(int(sr * seconds)) / sr
    f0 = 140.0 + 20.0 * np.sin(2 * np.pi * 0.7 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    wav = sum(0.3 / k * np.sin(k * phase) for k in (1, 2, 3))
    wav *= 0.5 + 0.5 * np.sin(2 * np.pi * 1.3 * t) ** 2
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    save_wav(wav.astype(np.float32), out, sr)
    print(f"| wrote {out} ({seconds}s @ {sr}Hz)")
    return out


if __name__ == "__main__":
    main(*sys.argv[1:2])
