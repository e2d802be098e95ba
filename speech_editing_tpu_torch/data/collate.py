"""Pad-collation and token-budgeted batching (host numpy), as the JAX
package's ``data/collate.py``: ``size_multiple`` rounds padded lengths up."""

from __future__ import annotations

import sys
from typing import Callable, List, Optional, Sequence

import numpy as np


def _round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple if multiple > 1 else n


def collate_1d(values: Sequence[np.ndarray], pad_idx=0, left_pad: bool = False,
               max_len: Optional[int] = None, size_multiple: int = 1) -> np.ndarray:
    """List of [T_i] arrays -> [B, T] padded."""
    size = max(len(v) for v in values) if max_len is None else max_len
    size = _round_up(size, size_multiple)
    res = np.full((len(values), size), pad_idx, dtype=np.asarray(values[0]).dtype)
    for i, v in enumerate(values):
        v = np.asarray(v)
        if left_pad:
            res[i, size - len(v):] = v
        else:
            res[i, :len(v)] = v
    return res


def collate_2d(values: Sequence[np.ndarray], pad_idx=0, left_pad: bool = False,
               max_len: Optional[int] = None, size_multiple: int = 1) -> np.ndarray:
    """List of [T_i, C] arrays -> [B, T, C] padded."""
    size = max(v.shape[0] for v in values) if max_len is None else max_len
    size = _round_up(size, size_multiple)
    v0 = np.asarray(values[0])
    res = np.full((len(values), size, v0.shape[1]), pad_idx, dtype=v0.dtype)
    for i, v in enumerate(values):
        v = np.asarray(v)
        if left_pad:
            res[i, size - v.shape[0]:] = v
        else:
            res[i, :v.shape[0]] = v
    return res


def collate_1d_or_2d(values, pad_idx=0, left_pad=False, max_len=None,
                     size_multiple: int = 1) -> np.ndarray:
    collate = collate_1d if np.asarray(values[0]).ndim == 1 else collate_2d
    return collate(values, pad_idx, left_pad, max_len, size_multiple)


def batch_by_size(indices, num_tokens_fn: Callable[[int], int],
                  max_tokens: Optional[int] = None,
                  max_sentences: Optional[int] = None,
                  required_batch_size_multiple: int = 1) -> List[List[int]]:
    """Greedy batches over the ordered ``indices``: a batch closes when it
    holds ``max_sentences`` items or when one more item would make
    (items x longest item) exceed ``max_tokens``; a closed batch is cut to
    a multiple of ``required_batch_size_multiple`` and the rest carries on."""
    max_tokens = max_tokens if max_tokens is not None else sys.maxsize
    max_sentences = max_sentences if max_sentences is not None else sys.maxsize
    bsz_mult = required_batch_size_multiple
    sample_len = 0
    sample_lens: list[int] = []
    batch: list[int] = []
    batches: list[list[int]] = []
    for idx in np.asarray(list(indices), dtype=np.int64):
        idx = int(idx)
        num_tokens = num_tokens_fn(idx)
        sample_lens.append(num_tokens)
        sample_len = max(sample_len, num_tokens)
        if sample_len > max_tokens:
            raise ValueError(f"sentence at index {idx} of size {sample_len} exceeds "
                             f"max_tokens limit of {max_tokens}!")
        full = batch and (len(batch) == max_sentences
                          or (len(batch) + 1) * sample_len > max_tokens)
        if full:
            mod_len = max(bsz_mult * (len(batch) // bsz_mult), len(batch) % bsz_mult)
            batches.append(batch[:mod_len])
            batch = batch[mod_len:]
            sample_lens = sample_lens[mod_len:]
            sample_len = max(sample_lens) if sample_lens else 0
        batch.append(idx)
    if batch:
        batches.append(batch)
    return batches
