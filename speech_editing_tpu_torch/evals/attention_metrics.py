"""Attention diagnostics + misc metrics.

Parity surface: ``utils/metrics/diagonal_metrics.py`` (focus rate, phone
coverage rate, diagonal focus rate), ``utils/metrics/laplace_var.py``
(sharpness proxy), ``utils/metrics/pitch_distance.py`` (DTW f0 distance).
Pure numpy; attention maps are [B, T_dec, T_enc].

The port's copy of the JAX package's ``evals/attention_metrics.py``.
"""

from __future__ import annotations

import numpy as np

from speech_editing_tpu_torch.evals.dtw import dtw_path


def get_focus_rate(attn: np.ndarray, src_padding_mask=None,
                   tgt_padding_mask=None) -> np.ndarray:
    """Max attention per decoder step, averaged (how 'focused' each step is)."""
    attn = np.array(attn, np.float64)
    if src_padding_mask is not None:
        attn = attn * (1 - src_padding_mask[:, None, :])
    if tgt_padding_mask is not None:
        attn = attn * (1 - tgt_padding_mask[:, :, None])
    focus = attn.max(-1).sum(1)
    denom = ((1 - tgt_padding_mask).sum(1) if tgt_padding_mask is not None
             else attn.shape[1])
    return focus / denom


def get_phone_coverage_rate(attn: np.ndarray, src_padding_mask=None,
                            src_seg_mask=None, tgt_padding_mask=None
                            ) -> np.ndarray:
    """Fraction of encoder tokens that receive attention >= 0.1 somewhere."""
    attn = np.array(attn, np.float64)
    mask = np.ones(attn.shape[::2], dtype=bool)  # [B, T_enc]
    if src_padding_mask is not None:
        mask &= ~src_padding_mask.astype(bool)
    if src_seg_mask is not None:
        mask &= ~src_seg_mask.astype(bool)
    if tgt_padding_mask is not None:
        attn = attn * (1 - tgt_padding_mask[:, :, None])
    covered = (attn.max(1) >= 0.1) & mask
    return covered.sum(-1) / np.maximum(mask.sum(-1), 1)


def get_diagonal_focus_rate(attn: np.ndarray, attn_ks: np.ndarray,
                            target_len: np.ndarray, src_padding_mask=None,
                            tgt_padding_mask=None, band_mask_factor: int = 5,
                            band_width: int = 50) -> np.ndarray:
    """Share of attention mass inside a diagonal band of slope attn_ks."""
    b, t_dec, t_enc = attn.shape
    attn = np.array(attn, np.float64)
    i = np.arange(t_dec)[None, :, None]
    j = np.arange(t_enc)[None, None, :]
    ks = np.asarray(attn_ks, np.float64).reshape(b, 1, 1)
    center = i / np.maximum(ks, 1e-8)
    width = np.maximum(
        np.asarray(target_len).reshape(b, 1, 1) / band_mask_factor, band_width)
    band = (np.abs(j - center) < width)
    masked = attn * band
    if src_padding_mask is not None:
        masked = masked * (1 - src_padding_mask[:, None, :])
        attn = attn * (1 - src_padding_mask[:, None, :])
    if tgt_padding_mask is not None:
        masked = masked * (1 - tgt_padding_mask[:, :, None])
        attn = attn * (1 - tgt_padding_mask[:, :, None])
    return masked.sum((1, 2)) / np.maximum(attn.sum((1, 2)), 1e-8)


def laplace_var(x: np.ndarray) -> float:
    """Variance of the discrete Laplacian — spectrogram sharpness proxy
    (utils/metrics/laplace_var.py)."""
    from scipy.ndimage import laplace

    return float(laplace(np.asarray(x, np.float64)).var())


def pitch_dtw_distance(f0_a: np.ndarray, f0_b: np.ndarray) -> float:
    """Mean DTW-aligned f0 distance over voiced frames
    (utils/metrics/pitch_distance.py role)."""
    a = np.asarray(f0_a, np.float64)[:, None]
    b = np.asarray(f0_b, np.float64)[:, None]
    cost, path = dtw_path(a, b)
    return cost / max(len(path), 1)
