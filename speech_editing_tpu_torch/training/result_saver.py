"""The test loop's writer for one item: ``wavs/<base_fn>.wav`` and, when
asked, ``wavs/<base_fn>_mel.npy``. The port of the JAX package's
``training/result_saver.py`` without the mel figure (matplotlib). It runs
in :class:`~speech_editing_tpu_torch.utils.multiprocess.ResultSaverPool`
workers, so it imports numpy and scipy only."""

from __future__ import annotations

from typing import Optional

import numpy as np


def save_test_result(wav_out: np.ndarray, mel: Optional[np.ndarray], base_fn: str,
                     gen_dir: str, sr: int, save_mel_npy: bool = False) -> str:
    """Write the wav (and ``mel`` as ``_mel.npy`` with ``save_mel_npy``);
    returns ``base_fn``."""
    from speech_editing_tpu_torch.utils.audio.io import save_wav

    save_wav(np.asarray(wav_out, np.float32), f"{gen_dir}/wavs/{base_fn}.wav", sr)
    if mel is not None and save_mel_npy:
        np.save(f"{gen_dir}/wavs/{base_fn}_mel.npy", np.asarray(mel, np.float32))
    return base_fn
