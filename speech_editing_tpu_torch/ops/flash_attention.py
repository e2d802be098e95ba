"""Kernels K3 and K4: softmax attention with key padding, forward
(``csrc/flash_attention.cu``) and backward (``csrc/flash_attention_bwd.cu``).

Replace the Pallas TPU flash attention that
``speech_editing_tpu/ops/flash_attention.py::flash_mha`` drives, and its
custom VJP. The plain forward is the einsum path of ``MultiheadAttention``
(``speech_editing_tpu/modules/transformer.py``). K3 writes each row's
logsumexp only when a gradient is needed; :class:`FlashAttentionFunction`
ties K3 and K4 together. Each is one launch per call, its products on the
tensor cores at float32 accuracy; the source notes in the ``.cu`` files
give each kernel's bound and design.
"""

from __future__ import annotations

import ctypes

import torch

from speech_editing_tpu_torch.ops.cuda.build import (check_status, check_tensor,
                                                     current_stream,
                                                     kernel_function, ptr)

NEG_INF = -1e9
_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_ARGTYPES = [_P] * 6 + [_I] * 5 + [_P]
_BWD_ARGTYPES = [_P] * 10 + [_I] * 5 + [_P]


def attention_plain(q, k, v, key_padding_mask=None):
    """Plain PyTorch version of K3: einsum softmax attention over
    [B, T, h, d] with an additive -1e9 bias on pad keys."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
    if key_padding_mask is not None:
        bias = torch.where(key_padding_mask, NEG_INF, 0.0).to(logits.dtype)
        logits = logits + bias[:, None, None, :]
    weights = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def _scores(q, k, key_padding_mask):
    """q.k logits [B, h, Tq, Tk], -inf at pad keys."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k)
    if key_padding_mask is None:
        return s
    return s.masked_fill(key_padding_mask[:, None, None, :], float("-inf"))


def attention_lse_plain(q, k, key_padding_mask=None):
    """Plain version of K3's second output: each query row's logsumexp over
    its valid keys, [B, h, Tq]; -inf for a row with none."""
    return torch.logsumexp(_scores(q, k, key_padding_mask), dim=-1)


def _check_mask(name, key_padding_mask, b, tk, device):
    if key_padding_mask is not None and (
            key_padding_mask.dtype != torch.bool or key_padding_mask.device != device
            or tuple(key_padding_mask.shape) != (b, tk)
            or not key_padding_mask.is_contiguous()):
        raise ValueError(f"{name}: key_padding_mask must be a contiguous "
                         f"bool [{b}, {tk}] tensor on {device}")


def flash_mha(q, k, v, key_padding_mask=None, return_lse: bool = False):
    """Softmax attention over [B, T, h, d]; q pre-scaled; key_padding_mask
    bool [B, Tk], True = pad key (zero weight). Returns [B, Tq, h, d], and
    the logsumexp [B, h, Tq] after it when ``return_lse``.

    A CPU tensor takes the plain version; a CUDA tensor launches K3. Rows
    whose keys are all padding differ (zeros here); callers mask them."""
    if q.device.type == "cpu":
        out = attention_plain(q, k, v, key_padding_mask)
        return (out, attention_lse_plain(q, k, key_padding_mask)) if return_lse else out
    if q.device.type != "cuda":
        raise ValueError(f"flash_mha: unsupported device {q.device}")
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if d > 128:
        raise ValueError(f"flash_mha: head width {d} > 128")
    check_tensor(q, "q", (b, tq, h, d), q.device)
    check_tensor(k, "k", (b, tk, h, d), q.device)
    check_tensor(v, "v", (b, tk, h, d), q.device)
    _check_mask("flash_mha", key_padding_mask, b, tk, q.device)
    out = torch.empty_like(q)
    lse = q.new_empty(b, h, tq) if return_lse else None
    fn = kernel_function("flash_attention", "attention_fwd_f32", _FWD_ARGTYPES)
    check_status(fn(ptr(q), ptr(k), ptr(v), ptr(key_padding_mask), ptr(out),
                    ptr(lse), b, tq, tk, h, d, current_stream()), "flash_mha")
    flash_mha.launches += 1
    return (out, lse) if return_lse else out


flash_mha.launches = 0


def attention_bwd_plain(q, k, v, o, lse, do, key_padding_mask=None):
    """Plain PyTorch version of K4: (dq, dk, dv), with the probabilities
    recomputed from ``lse`` as K4 does; 0 for pad keys and for rows with no
    valid key (lse = -inf)."""
    s = _scores(q, k, key_padding_mask)
    live = torch.isfinite(lse)[..., None] & torch.isfinite(s)
    p = torch.where(live, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    di = (o * do).sum(-1).transpose(1, 2)                    # [B, h, Tq]
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", do, v) - di[..., None])
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k),
            torch.einsum("bhqk,bqhd->bkhd", ds, q),
            torch.einsum("bhqk,bqhd->bkhd", p, do))


def flash_mha_bwd(q, k, v, o, lse, do, key_padding_mask=None):
    """q, o, do [B, Tq, h, d]; k, v [B, Tk, h, d]; lse [B, h, Tq] from
    ``flash_mha(..., return_lse=True)`` -> (dq, dk, dv).

    A CPU tensor takes the plain version; a CUDA tensor launches K4, one
    kernel that also forms ``di = rowsum(o * do)``, which JAX's
    ``_flash_attention_bwd`` computes outside its kernels."""
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, o, lse, do, key_padding_mask)
    if q.device.type != "cuda":
        raise ValueError(f"flash_mha_bwd: unsupported device {q.device}")
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if d > 128:
        raise ValueError(f"flash_mha_bwd: head width {d} > 128")
    for name, tensor, shape in (("q", q, (b, tq, h, d)), ("k", k, (b, tk, h, d)),
                                ("v", v, (b, tk, h, d)), ("o", o, (b, tq, h, d)),
                                ("do", do, (b, tq, h, d)), ("lse", lse, (b, h, tq))):
        check_tensor(tensor, name, shape, q.device)
    _check_mask("flash_mha_bwd", key_padding_mask, b, tk, q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    fn = kernel_function("flash_attention_bwd", "attention_bwd_f32", _BWD_ARGTYPES)
    check_status(fn(ptr(q), ptr(k), ptr(v), ptr(o), ptr(do), ptr(lse),
                    ptr(key_padding_mask), ptr(dq), ptr(dk), ptr(dv),
                    b, tq, tk, h, d, current_stream()), "flash_mha_bwd")
    flash_mha_bwd.launches += 1
    return dq, dk, dv


flash_mha_bwd.launches = 0


class FlashAttentionFunction(torch.autograd.Function):
    """K3 forward (saving the logsumexp) and K4 backward; the plain versions
    of both on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, key_padding_mask):
        out, lse = flash_mha(q, k, v, key_padding_mask, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, key_padding_mask)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, mask = ctx.saved_tensors
        return (*flash_mha_bwd(q, k, v, out, lse, do.contiguous(), mask), None)


def flash_mha_train(q, k, v, key_padding_mask=None):
    """:func:`flash_mha` with a gradient: K3 forward, K4 backward."""
    return FlashAttentionFunction.apply(q, k, v, key_padding_mask)
