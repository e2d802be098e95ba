"""Conformer layers with the legacy ESPnet relative-position attention, the
port of the JAX package's ``modules/conformer.py`` (A3T's encoder and
decoder).

Macaron feed-forwards (x 0.5), relative-position attention with
``pos_bias_u``/``pos_bias_v`` and the legacy pad-and-reshape rel-shift, a
GLU + depthwise-conv module, pre-LN; masking only at the attention keys and
the stack output, as the reference. In pad-safe mode (A3T's
``serve_pad_safe_a3t``) the conv module masks padded lanes and the
rel-shift is evaluated at each row's true length. The attention is plain
PyTorch (the JAX package has no kernel for it either). Norms: ``ln``
(LayerNorm) or ``affine``, the reference's BatchNorm in eval mode, whose
running statistics a converted checkpoint carries. Parameter names are the
reference torch modules' (``encoder_layers.{i}.feed_forward_macaron.w_1``
and so on; the pointwise layers are 1-wide ``Conv1d``s), as
``convert_conformer_layers`` reads them.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from speech_editing_tpu_torch.utils.dtypes import promoted, widen

ESPNET_MAX_LEN = 5000  # the reference RelPositionalEncoding's max_len


@functools.lru_cache(maxsize=4)
def _rel_pos_table(dim: int, max_len: int) -> np.ndarray:
    pos = np.arange(max_len - 1, -1, -1.0, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float64) * -(math.log(10000.0) / dim))
    pe = np.zeros((max_len, dim))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe.astype(np.float32)


def espnet_rel_pos_emb(t: int, dim: int, device=None,
                       max_len: int = ESPNET_MAX_LEN) -> torch.Tensor:
    """The first ``t`` rows [t, dim] of the reference's table of reversed
    positions: row i holds position ``max_len - 1 - i``."""
    return torch.from_numpy(_rel_pos_table(dim, max_len)[:t]).to(device)


def legacy_rel_shift(x: torch.Tensor) -> torch.Tensor:
    """ESPnet's legacy rel-shift of [B, H, T1, T2]: pad one zero column in
    front, read the result as [T2 + 1, T1], drop the first row."""
    b, h, t1, t2 = x.shape
    x = F.pad(x, (1, 0)).view(b, h, t2 + 1, t1)
    return x[:, :, 1:].reshape(b, h, t1, t2)


def true_len_rel_shift(x: torch.Tensor, true_len: torch.Tensor) -> torch.Tensor:
    """:func:`legacy_rel_shift` with its length T taken per row from
    ``true_len`` [B]: for i, j < true_len[b] row b equals the legacy shift of
    its unpadded sequence. Entry (i, j) reads x[i, L-1-(i-j)] for j <= i,
    0 at j = i + 1, and x[i+1, j-i-2] beyond."""
    b, h, t1, t2 = x.shape
    i = torch.arange(t1, device=x.device)[:, None]
    j = torch.arange(t2, device=x.device)[None, :]
    length = true_len.long().view(b, 1, 1)
    r_idx = torch.where(j > i, i + 1, i).expand(b, t1, t2)
    c_idx = torch.where(j > i, j - i - 2, length - 1 - (i - j))
    flat = (r_idx * t2 + c_idx.clamp(0, t2 - 1)).clamp(0, t1 * t2 - 1)
    y = torch.gather(x.reshape(b, h, t1 * t2), 2,
                     flat.reshape(b, 1, t1 * t2).expand(b, h, t1 * t2))
    return y.view(b, h, t1, t2).masked_fill((j == i + 1)[None, None], 0.0)


class RelPositionMultiHeadAttention(nn.Module):
    """Legacy ESPnet RelPositionMultiHeadedAttention: biased q/k/v/out
    linears, a bias-free position projection, ``pos_bias_u``/``pos_bias_v``
    [h, d], content scores plus rel-shifted position scores over sqrt(d),
    in float32, pad keys filled with float32's least value before the
    softmax and with zero after it."""

    def __init__(self, hidden_size: int, num_heads: int = 4):
        super().__init__()
        self.num_heads = num_heads
        d = hidden_size // num_heads
        self.linear_q = nn.Linear(hidden_size, hidden_size)
        self.linear_k = nn.Linear(hidden_size, hidden_size)
        self.linear_v = nn.Linear(hidden_size, hidden_size)
        self.linear_out = nn.Linear(hidden_size, hidden_size)
        self.linear_pos = nn.Linear(hidden_size, hidden_size, bias=False)
        self.pos_bias_u = nn.Parameter(torch.zeros(num_heads, d))
        self.pos_bias_v = nn.Parameter(torch.zeros(num_heads, d))

    def forward(self, x, pos_emb, nonpadding, true_len=None):
        """x [B, T, H]; pos_emb [B or 1, T, H]; nonpadding [B, T] float;
        true_len [B] (pad-safe mode) or None."""
        b, t, hid = x.shape
        nh, d = self.num_heads, hid // self.num_heads
        q = self.linear_q(x).view(b, t, nh, d)
        k = self.linear_k(x).view(b, t, nh, d)
        v = self.linear_v(x).view(b, t, nh, d)
        # flax promotes the float32 table over bf16 weights: float32 here
        p = promoted(self.linear_pos, pos_emb)
        p = p.view(pos_emb.shape[0], -1, nh, d).expand(b, -1, -1, -1)
        # scores in f32 (from bf16 operands under use_bf16, as JAX's
        # preferred_element_type forms them); the weights meet v in its dtype
        ac = torch.einsum("bthd,bshd->bhts", widen(q + self.pos_bias_u), widen(k))
        bd = torch.einsum("bthd,bshd->bhts", widen(q + self.pos_bias_v), widen(p))
        bd = legacy_rel_shift(bd) if true_len is None else true_len_rel_shift(bd, true_len)
        scores = (ac + bd) / math.sqrt(d)
        pad = (nonpadding <= 0)[:, None, None, :]
        scores = scores.masked_fill(pad, torch.finfo(torch.float32).min)
        attn = torch.softmax(scores, dim=-1).masked_fill(pad, 0.0)
        out = torch.einsum("bhts,bshd->bthd", attn.to(v.dtype), v)
        return self.linear_out(out.reshape(b, t, hid))


class Pointwise(nn.Conv1d):
    """A 1-wide ``Conv1d`` (the reference's layout) applied to [B, T, C] as
    a linear layer."""

    def __init__(self, in_channels: int, out_channels: int, bias: bool = True):
        super().__init__(in_channels, out_channels, 1, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight[:, :, 0], self.bias)


class AffineNorm(nn.BatchNorm1d):
    """The reference's BatchNorm1d in eval mode on [B, T, C]: a per-channel
    affine map from its running statistics (the JAX package's ``affine``
    norm with the statistics folded in)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x.reshape(-1, x.shape[-1]), self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps).view_as(x)


def make_norm(norm_type: str, channels: int) -> nn.Module:
    """``ln`` (training) or ``affine`` (a converted reference checkpoint)."""
    if norm_type == "affine":
        return AffineNorm(channels, eps=1e-5)
    if norm_type == "ln":
        return nn.LayerNorm(channels, eps=1e-5)
    raise NotImplementedError(f"norm_type={norm_type!r} (ported: 'ln', 'affine')")


class ConvolutionModule(nn.Module):
    """GLU pointwise -> depthwise conv (SAME) -> norm -> swish -> pointwise;
    padded lanes zeroed before the depthwise conv when ``nonpadding`` is
    given (pad-safe mode)."""

    def __init__(self, hidden_size: int, kernel_size: int = 9, norm_type: str = "ln"):
        super().__init__()
        self.kernel_size = kernel_size
        self.pointwise_conv1 = Pointwise(hidden_size, 2 * hidden_size)
        self.depthwise_conv = nn.Conv1d(hidden_size, hidden_size, kernel_size,
                                        groups=hidden_size)
        self.norm = make_norm(norm_type, hidden_size)
        self.pointwise_conv2 = Pointwise(hidden_size, hidden_size)

    def forward(self, x, nonpadding=None):
        x = F.glu(self.pointwise_conv1(x), dim=-1)
        if nonpadding is not None:
            x = x * nonpadding[:, :, None]
        k = self.kernel_size
        x = self.depthwise_conv(F.pad(x.transpose(1, 2), ((k - 1) // 2, k // 2)))
        return self.pointwise_conv2(F.silu(self.norm(x.transpose(1, 2))))


class _FFN(nn.Module):
    """ESPnet's MultiLayeredConv1d with 1-wide kernels: w_1, ReLU, w_2."""

    def __init__(self, hidden_size: int, expansion: int = 4):
        super().__init__()
        self.w_1 = Pointwise(hidden_size, hidden_size * expansion)
        self.w_2 = Pointwise(hidden_size * expansion, hidden_size)

    def forward(self, x):
        return self.w_2(torch.relu(self.w_1(x)))


class ConformerEncoderLayer(nn.Module):
    """Macaron conformer block, pre-LN; the block output is not re-masked."""

    def __init__(self, hidden_size: int, kernel_size: int = 9, num_heads: int = 4,
                 norm_type: str = "ln", pad_safe: bool = False):
        super().__init__()
        self.pad_safe = pad_safe
        ln = lambda: nn.LayerNorm(hidden_size, eps=1e-5)
        self.feed_forward_macaron = _FFN(hidden_size)
        self.norm_ff_macaron = ln()
        self.self_attn = RelPositionMultiHeadAttention(hidden_size, num_heads)
        self.norm_mha = ln()
        self.conv_module = ConvolutionModule(hidden_size, kernel_size, norm_type)
        self.norm_conv = ln()
        self.feed_forward = _FFN(hidden_size)
        self.norm_ff = ln()
        self.norm_final = ln()

    def forward(self, x, pos_emb, nonpadding):
        true_len = nonpadding.sum(-1) if self.pad_safe else None
        x = x + 0.5 * self.feed_forward_macaron(self.norm_ff_macaron(x))
        x = x + self.self_attn(self.norm_mha(x), pos_emb, nonpadding, true_len)
        x = x + self.conv_module(self.norm_conv(x), nonpadding if self.pad_safe else None)
        x = x + 0.5 * self.feed_forward(self.norm_ff(x))
        return self.norm_final(x)


class ConformerLayers(nn.Module):
    """``num_layers`` conformer blocks, a last LayerNorm, the output masked;
    ``nonpadding`` defaults to the frames with any non-zero feature and
    ``pos_emb`` to the reference's reversed table."""

    def __init__(self, hidden_size: int, num_layers: int, kernel_size: int = 9,
                 num_heads: int = 4, norm_type: str = "ln", pad_safe: bool = False):
        super().__init__()
        self.hidden_size = hidden_size
        self.encoder_layers = nn.ModuleList(
            ConformerEncoderLayer(hidden_size, kernel_size, num_heads, norm_type, pad_safe)
            for _ in range(num_layers))
        self.layer_norm = nn.LayerNorm(hidden_size, eps=1e-5)

    def forward(self, x, pos_emb=None, nonpadding=None):
        if nonpadding is None:
            nonpadding = (x.abs().sum(-1) > 0).to(x.dtype)
        if pos_emb is None:
            pos_emb = espnet_rel_pos_emb(x.shape[1], self.hidden_size, x.device)[None]
        for layer in self.encoder_layers:
            x = layer(x, pos_emb, nonpadding)
        return self.layer_norm(x) * nonpadding[:, :, None]
