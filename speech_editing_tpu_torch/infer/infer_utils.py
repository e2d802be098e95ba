"""Helpers of the region-edit API, host numpy: the port's copy of the
JAX package's ``infer/infer_utils.py`` (region strings, word-region
resolution against the separator-bearing word list, TextGrid alignment,
f0/uv of the source wav)."""

from __future__ import annotations

import os
import re
from typing import List

import numpy as np

from speech_editing_tpu_torch.utils.audio.align import get_mel2ph
from speech_editing_tpu_torch.utils.audio.pitch import extract_pitch, norm_interp_f0
from speech_editing_tpu_torch.utils.text.text_encoder import is_sil_phoneme


def parse_region_list_from_str(region_str: str) -> List[List[int]]:
    """'[4,6][9,9]' -> [[4,6],[9,9]] (1-based content-word indices)."""
    pattern = r"\[([1-9]\d*),([1-9]\d*)\]"
    region_list = [[int(a), int(b)] for a, b in re.findall(pattern, region_str)]
    return sorted(region_list, key=lambda x: x[0])


def get_words_region_from_origintxt_region(words: List[str],
                                           region_list: List[List[int]]
                                           ) -> List[List[int]]:
    """Map 1-based content-word indices to 1-based positions in the full
    txt_struct word list (which contains <BOS>/|/<EOS> separators)."""
    word_id = 0
    region_id = 0
    words_region = [[0, 0] for _ in range(len(region_list))]
    assert len(region_list) >= 1, "empty region list"
    for i, word in enumerate(words):
        if is_sil_phoneme(word) and word in ["|", "<BOS>", "<pad>"]:
            continue
        word_id += 1
        if word_id == region_list[region_id][0]:
            words_region[region_id][0] = i + 1
        if word_id == region_list[region_id][1]:
            words_region[region_id][1] = i + 1
            region_id += 1
        if region_id == len(region_list):
            break
    return words_region


def get_align_from_mfa_output(tg_fn: str, ph: str, ph_token, mel: np.ndarray,
                              hop_size: int = 256, sample_rate: int = 22050,
                              min_sil_duration: float = 0.1):
    if tg_fn is None or not os.path.exists(tg_fn):
        raise FileNotFoundError(f"Align not found: {tg_fn}")
    mel2ph, dur = get_mel2ph(tg_fn, ph, mel, hop_size, sample_rate,
                             min_sil_duration)
    if np.array(mel2ph).max() - 1 >= len(ph_token):
        raise ValueError(
            f"Align does not match: mel2ph.max()-1={np.array(mel2ph).max() - 1}"
            f" vs len(ph_token)={len(ph_token)}")
    return mel2ph, dur


def extract_f0_uv(wav: np.ndarray, mel: np.ndarray, hop_size: int = 256,
                  sample_rate: int = 22050, f0_min: float = 80,
                  f0_max: float = 600):
    t = mel.shape[0]
    f0 = extract_pitch("autocorr", wav, hop_size, sample_rate,
                       f0_min=f0_min, f0_max=f0_max)
    f0 = f0[:t]
    if len(f0) < t:
        f0 = np.pad(f0, (0, t - len(f0)))
    f0, uv = norm_interp_f0(f0)
    return f0, uv
