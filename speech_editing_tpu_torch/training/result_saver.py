"""The test loop's writer for one item: ``wavs/<base_fn>.wav``, when asked
``wavs/<base_fn>_mel.npy``, and with ``hp_plot`` the mel figure
``plot/<base_fn>.png`` (the heatmap, the f0 tracked from the written wav,
and each phone's last frame when ``mel2ph`` and its phones are given). The
port of the JAX package's ``training/result_saver.py``. It runs in
:class:`~speech_editing_tpu_torch.utils.multiprocess.ResultSaverPool`
workers, so it imports numpy and scipy at the top, and matplotlib only to
draw; without matplotlib no figure is drawn."""

from __future__ import annotations

import os
import traceback
from typing import Optional

import numpy as np


def save_test_result(wav_out: np.ndarray, mel: Optional[np.ndarray], base_fn: str,
                     gen_dir: str, sr: int, save_mel_npy: bool = False,
                     hp_plot: Optional[dict] = None, str_phs: Optional[str] = None,
                     mel2ph: Optional[np.ndarray] = None) -> str:
    """Write the wav (and ``mel`` as ``_mel.npy`` with ``save_mel_npy``, and
    its figure with ``hp_plot``: ``hop_size``, ``mel_vmin``, ``mel_vmax``);
    returns ``base_fn``."""
    from speech_editing_tpu_torch.utils.audio.io import save_wav
    from speech_editing_tpu_torch.utils.plot import have_matplotlib

    save_wav(np.asarray(wav_out, np.float32), f"{gen_dir}/wavs/{base_fn}.wav", sr)
    if mel is None:
        return base_fn
    mel = np.asarray(mel, np.float32)
    if save_mel_npy:
        np.save(f"{gen_dir}/wavs/{base_fn}_mel.npy", mel)
    if hp_plot is None or not have_matplotlib():
        return base_fn
    try:
        _plot(np.asarray(wav_out, np.float32), mel, base_fn, gen_dir, sr, hp_plot, str_phs,
              mel2ph)
    except Exception:     # a figure must never stop the test loop
        traceback.print_exc()
    return base_fn


def _plot(wav, mel, base_fn, gen_dir, sr, hp_plot, str_phs, mel2ph) -> None:
    from speech_editing_tpu_torch.utils.audio.align import mel2token_to_dur
    from speech_editing_tpu_torch.utils.audio.pitch import extract_pitch
    from speech_editing_tpu_torch.utils.plot import _plt, spec_to_figure

    try:    # f0 of the written wav, plotted at f0 / 10 over the mel bins
        f0 = np.asarray(extract_pitch("autocorr", wav, int(hp_plot.get("hop_size", 256)), sr),
                        np.float32)
        f0 = f0 * (f0 > 0)
    except Exception:
        f0 = None
    dur_info = None
    if mel2ph is not None and str_phs:
        txt = str_phs.split(" ")
        dur_info = {"dur_gt": mel2token_to_dur(np.asarray(mel2ph), len(txt)), "txt": txt}
    fig = spec_to_figure(mel, vmin=hp_plot.get("mel_vmin", -6),
                         vmax=hp_plot.get("mel_vmax", 1.5), title=base_fn,
                         f0s=None if f0 is None else {"f0": f0}, dur_info=dur_info)
    os.makedirs(f"{gen_dir}/plot", exist_ok=True)
    fig.savefig(f"{gen_dir}/plot/{base_fn}.png", format="png")
    _plt().close(fig)
