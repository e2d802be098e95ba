"""Kernel K3: softmax attention forward with key padding
(``csrc/flash_attention.cu``).

Replaces the Pallas TPU flash-attention forward that
``speech_editing_tpu/ops/flash_attention.py::flash_mha`` drives. Its plain
version is the einsum path of ``MultiheadAttention``
(``speech_editing_tpu/modules/transformer.py``). The source note in the
``.cu`` file gives the bound and the design.
"""

from __future__ import annotations

import ctypes

import torch

from speech_editing_tpu_torch.ops.cuda.build import (check_status, check_tensor,
                                                     current_stream,
                                                     kernel_function, ptr)

NEG_INF = -1e9
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_P] * 5 + [_I] * 5 + [_P]


def attention_plain(q, k, v, key_padding_mask=None):
    """Plain PyTorch version of K3: einsum softmax attention over
    [B, T, h, d] with an additive -1e9 bias on pad keys."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
    if key_padding_mask is not None:
        bias = torch.where(key_padding_mask, NEG_INF, 0.0).to(logits.dtype)
        logits = logits + bias[:, None, None, :]
    weights = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def flash_mha(q, k, v, key_padding_mask=None):
    """Softmax attention over [B, T, h, d]; q pre-scaled; key_padding_mask
    bool [B, Tk], True = pad key (zero weight). Returns [B, Tq, h, d].

    A CPU tensor takes the plain version; a CUDA tensor launches K3. Rows
    whose keys are all padding differ (zeros here); callers mask them."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, key_padding_mask)
    if q.device.type != "cuda":
        raise ValueError(f"flash_mha: unsupported device {q.device}")
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if d > 128:
        raise ValueError(f"flash_mha: head width {d} > 128")
    check_tensor(q, "q", (b, tq, h, d), q.device)
    check_tensor(k, "k", (b, tk, h, d), q.device)
    check_tensor(v, "v", (b, tk, h, d), q.device)
    if key_padding_mask is not None:
        if (key_padding_mask.dtype != torch.bool or key_padding_mask.device != q.device
                or tuple(key_padding_mask.shape) != (b, tk)
                or not key_padding_mask.is_contiguous()):
            raise ValueError("flash_mha: key_padding_mask must be a contiguous "
                             f"bool [{b}, {tk}] tensor on {q.device}")
    out = torch.empty_like(q)
    fn = kernel_function("flash_attention", "attention_fwd_f32", _ARGTYPES)
    check_status(fn(ptr(q), ptr(k), ptr(v), ptr(key_padding_mask), ptr(out),
                    b, tq, tk, h, d, current_stream()), "flash_mha")
    flash_mha.launches += 1
    return out


flash_mha.launches = 0
