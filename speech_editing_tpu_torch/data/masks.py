"""The time masks of speech-editing training and evaluation (host numpy,
float32 [T], drawn from an explicit ``np.random.RandomState``), as the JAX
package's ``data/masks.py``."""

from __future__ import annotations

import numpy as np


def generate_time_mask(t_frames: int, ratio: float,
                       rng: np.random.RandomState) -> np.ndarray:
    """One random contiguous span of ``ratio`` of the frames."""
    mask_length = int(t_frames * ratio)
    pos = rng.randint(0, max(1, t_frames - mask_length))
    mask = np.zeros(t_frames, np.float32)
    mask[pos:pos + mask_length] = 1.0
    return mask


def _ph_mask_to_frames(ph_mask: np.ndarray, mel2ph: np.ndarray) -> np.ndarray:
    """A phone mask [P] -> frames through mel2ph (id 0, padding, unmasked)."""
    return np.concatenate([[0.0], ph_mask]).astype(np.float32)[mel2ph]


def generate_alignment_aware_time_mask(mel2ph: np.ndarray, ratio: float,
                                       rng: np.random.RandomState) -> np.ndarray:
    """A random subset of the phones, ``int((P + 1) * ratio)`` of them, at
    frame level."""
    num_ph = int(mel2ph.max())
    if num_ph <= 0:
        return np.zeros(len(mel2ph), np.float32)
    n_masked = int((num_ph + 1) * ratio)
    ph_mask = np.zeros(num_ph, np.float32)
    if n_masked > 0:
        ph_mask[rng.choice(num_ph, size=min(n_masked, num_ph), replace=False)] = 1.0
    return _ph_mask_to_frames(ph_mask, mel2ph)


def generate_inference_mask(mel2ph: np.ndarray, ratio: float,
                            rng: np.random.RandomState) -> np.ndarray:
    """One contiguous span of ``ratio`` of the phones, at frame level."""
    num_ph = int(mel2ph.max())
    if num_ph <= 0:
        return np.zeros(len(mel2ph), np.float32)
    span = int(num_ph * ratio)
    start = rng.randint(0, max(1, num_ph - span + 1))
    ph_mask = np.zeros(num_ph, np.float32)
    ph_mask[start:start + span] = 1.0
    return _ph_mask_to_frames(ph_mask, mel2ph)
