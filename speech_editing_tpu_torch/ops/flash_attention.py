"""Kernels K3 and K4: softmax attention with key padding, forward
(``csrc/flash_attention.cu``) and backward (``csrc/flash_attention_bwd.cu``).

Replace the Pallas TPU flash attention that
``speech_editing_tpu/ops/flash_attention.py::flash_mha`` drives, and its
custom VJP. The plain forward is the einsum path of ``MultiheadAttention``
(``speech_editing_tpu/modules/transformer.py``). K3 writes each row's
logsumexp only when a gradient is needed; :class:`FlashAttentionFunction`
ties K3 and K4 together. Each is one launch per call, its products on the
tensor cores at float32 accuracy, or, for bfloat16 tensors, in bf16 with f32
accumulation at the Pallas kernel's rounding points (the bf16 plain versions
say where); the wrappers dispatch on the dtype and count launches per dtype
(``launches``, ``launches_bf16``). The source notes in the ``.cu`` files give
each kernel's bound and design. :func:`flash_mha_takes` states their
envelope (head widths up to 128, float32 or bfloat16); on the card a call
outside it raises, naming the kernel and the shape.
"""

from __future__ import annotations

import ctypes

import torch

from speech_editing_tpu_torch.ops.cuda.build import (check_status, check_tensor,
                                                     current_stream,
                                                     kernel_function, ptr)
from speech_editing_tpu_torch.utils.dtypes import widen

NEG_INF = -1e9
_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_ARGTYPES = [_P] * 6 + [_I] * 5 + [_P]
_BWD_ARGTYPES = [_P] * 10 + [_I] * 5 + [_P]
_MAX_D = 128        # the widest head the kernels are compiled for
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}   # the entry points a dtype


def flash_mha_takes(d: int, dtype) -> bool:
    """Whether K3 and K4 run heads of width ``d`` in ``dtype``: d up to 128,
    float32 or bfloat16."""
    return 0 < d <= _MAX_D and dtype in _SUFFIX


def _check_envelope(who: str, d: int, dtype) -> None:
    if not flash_mha_takes(d, dtype):
        raise ValueError(f"{who}: head width {d}, dtype {dtype} is outside the kernel's "
                         f"envelope (d up to {_MAX_D}, float32 or bfloat16); run it on "
                         "the CPU")


def _count(wrapper, dtype) -> None:
    if dtype == torch.float32:
        wrapper.launches += 1
    else:
        wrapper.launches_bf16 += 1


def _plain_bf16(q, k, v, key_padding_mask):
    """K3's bf16 form, rounded where the Pallas forward rounds: s = q.k in
    f32 from the bf16 operands, p = exp(s - rowmax) in f32, P.V with p cast
    to bf16 and f32 accumulation, times the reciprocal of the f32 row sum of
    p, stored as bf16. A row with no valid key gives zeros, as the kernel
    does."""
    s = _scores(q, k, key_padding_mask)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(torch.bfloat16).float(), v.float())
    o = o * torch.where(l > 0, 1.0 / l, torch.zeros_like(l))
    return o.transpose(1, 2).to(torch.bfloat16)


def attention_plain(q, k, v, key_padding_mask=None):
    """Plain PyTorch version of K3: einsum softmax attention over
    [B, T, h, d] with an additive -1e9 bias on pad keys; for bf16 tensors
    the Pallas kernel's bf16 arithmetic (``_plain_bf16``)."""
    if q.dtype == torch.bfloat16:
        return _plain_bf16(q, k, v, key_padding_mask)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
    if key_padding_mask is not None:
        bias = torch.where(key_padding_mask, NEG_INF, 0.0).to(logits.dtype)
        logits = logits + bias[:, None, None, :]
    weights = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def _scores(q, k, key_padding_mask):
    """q.k logits [B, h, Tq, Tk], -inf at pad keys; in f32 from bf16
    operands (their products are exact in f32)."""
    s = torch.einsum("bqhd,bkhd->bhqk", widen(q), widen(k))
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
    the logsumexp [B, h, Tq] (float32) after it when ``return_lse``.
    q, k, v float32, or all bfloat16.

    A CPU tensor takes the plain version; a CUDA tensor launches K3 (its
    float32 or bf16 form). Rows whose keys are all padding differ in float32
    (zeros here); callers mask them."""
    if q.device.type == "cpu":
        out = attention_plain(q, k, v, key_padding_mask)
        return (out, attention_lse_plain(q, k, key_padding_mask)) if return_lse else out
    if q.device.type != "cuda":
        raise ValueError(f"flash_mha: unsupported device {q.device}")
    b, tq, h, d = q.shape
    tk = k.shape[1]
    _check_envelope("flash_mha", d, q.dtype)
    check_tensor(q, "q", (b, tq, h, d), q.device, q.dtype)
    check_tensor(k, "k", (b, tk, h, d), q.device, q.dtype)
    check_tensor(v, "v", (b, tk, h, d), q.device, q.dtype)
    _check_mask("flash_mha", key_padding_mask, b, tk, q.device)
    out = torch.empty_like(q)
    lse = q.new_empty(b, h, tq, dtype=torch.float32) if return_lse else None
    fn = kernel_function("flash_attention", f"attention_fwd_{_SUFFIX[q.dtype]}",
                         _FWD_ARGTYPES)
    check_status(fn(ptr(q), ptr(k), ptr(v), ptr(key_padding_mask), ptr(out),
                    ptr(lse), b, tq, tk, h, d, current_stream()), "flash_mha")
    _count(flash_mha, q.dtype)
    return (out, lse) if return_lse else out


flash_mha.launches = flash_mha.launches_bf16 = 0


def attention_bwd_plain(q, k, v, o, lse, do, key_padding_mask=None):
    """Plain PyTorch version of K4: (dq, dk, dv), with the probabilities
    recomputed from ``lse`` as K4 does; 0 for pad keys and for rows with no
    valid key (lse = -inf). For bf16 tensors it rounds where the Pallas
    backward rounds: the products of the bf16 operands, p, di =
    rowsum(o.do) and ds = p (dp - di) in f32; p cast to bf16 for dv, ds for
    dk and dq, each accumulated in f32 and stored as bf16."""
    s = _scores(q, k, key_padding_mask)
    live = torch.isfinite(lse)[..., None] & torch.isfinite(s)
    p = torch.where(live, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    di = (widen(o) * widen(do)).sum(-1).transpose(1, 2)      # [B, h, Tq]
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", widen(do), widen(v)) - di[..., None])
    rounded = lambda t: widen(t.to(q.dtype))    # an operand as the kernel's products read it
    grads = (torch.einsum("bhqk,bkhd->bqhd", rounded(ds), widen(k)),
             torch.einsum("bhqk,bqhd->bkhd", rounded(ds), widen(q)),
             torch.einsum("bhqk,bqhd->bkhd", rounded(p), widen(do)))
    return tuple(g.to(q.dtype) for g in grads)


def flash_mha_bwd(q, k, v, o, lse, do, key_padding_mask=None):
    """q, o, do [B, Tq, h, d]; k, v [B, Tk, h, d]; lse [B, h, Tq] from
    ``flash_mha(..., return_lse=True)`` -> (dq, dk, dv) in q's dtype (lse
    float32, the rest float32 or all bfloat16).

    A CPU tensor takes the plain version; a CUDA tensor launches K4 (its
    float32 or bf16 form), one
    kernel that also forms ``di = rowsum(o * do)``, which JAX's
    ``_flash_attention_bwd`` computes outside its kernels."""
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, o, lse, do, key_padding_mask)
    if q.device.type != "cuda":
        raise ValueError(f"flash_mha_bwd: unsupported device {q.device}")
    b, tq, h, d = q.shape
    tk = k.shape[1]
    _check_envelope("flash_mha_bwd", d, q.dtype)
    for name, tensor, shape in (("q", q, (b, tq, h, d)), ("k", k, (b, tk, h, d)),
                                ("v", v, (b, tk, h, d)), ("o", o, (b, tq, h, d)),
                                ("do", do, (b, tq, h, d))):
        check_tensor(tensor, name, shape, q.device, q.dtype)
    check_tensor(lse, "lse", (b, h, tq), q.device)
    _check_mask("flash_mha_bwd", key_padding_mask, b, tk, q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    fn = kernel_function("flash_attention_bwd", f"attention_bwd_{_SUFFIX[q.dtype]}",
                         _BWD_ARGTYPES)
    check_status(fn(ptr(q), ptr(k), ptr(v), ptr(o), ptr(do), ptr(lse),
                    ptr(key_padding_mask), ptr(dq), ptr(dk), ptr(dv),
                    b, tq, tk, h, d, current_stream()), "flash_mha_bwd")
    _count(flash_mha_bwd, q.dtype)
    return dq, dk, dv


flash_mha_bwd.launches = flash_mha_bwd.launches_bf16 = 0


class FlashAttentionFunction(torch.autograd.Function):
    """K3 forward (saving the logsumexp) and K4 backward, in float32 or
    bf16 as the inputs are; the plain versions of both on CPU tensors."""

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
