"""Residual conv stacks and the conv text encoder, ``[B, T, C]``.

The port of the JAX package's ``modules/conv.py`` (``ResidualBlock``,
``ConvBlocks``, ``TextConvEncoder``, ``ConditionalConvBlocks``). Dropout
(``dropout`` > 0, in training only) draws its masks from an explicit
``torch.Generator``. Parameter names follow the reference
torch modules that ``convert_text_conv_encoder`` reads: block ``i`` of
residual block ``j`` is ``res_blocks.{j}.blocks.{i}`` = (norm, conv,
scale, GELU, 1x1 conv), then ``last_norm`` and ``post_net1``. Norm types
``ln`` (LayerNorm, eps 1e-5) and ``gn`` (GroupNorm with 8 groups over
frames and channels, flax's eps 1e-6).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from speech_editing_tpu_torch.modules.predictors import dropout as drop
from speech_editing_tpu_torch.modules.transformer import TokenEmbedding
from speech_editing_tpu_torch.utils.dtypes import gelu, weak


class _GroupNorm(nn.GroupNorm):
    """GroupNorm on ``[B, T, C]``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.transpose(1, 2)).transpose(1, 2)


def make_norm(norm_type: str, channels: int) -> nn.Module:
    if norm_type == "ln":
        return nn.LayerNorm(channels, eps=1e-5)
    if norm_type == "gn":
        return _GroupNorm(8, channels, eps=1e-6)
    raise NotImplementedError(f"norm_type={norm_type!r} (ported: 'ln', 'gn')")


def conv_same(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` over ``x`` [B, T, C] with flax's SAME padding: the
    dilated kernel's (k - 1) * d frames split low half first."""
    total = conv.dilation[0] * (conv.kernel_size[0] - 1)
    y = F.pad(x.transpose(1, 2), (total // 2, total - total // 2))
    return conv(y).transpose(1, 2)


class ResidualBlock(nn.Module):
    """``n`` x (norm, masked; dilated conv to ``c_multiple`` x channels,
    scaled by kernel_size^-0.5; exact GELU; 1x1 conv; dropout) with
    residual adds, re-masked after each."""

    def __init__(self, channels: int, kernel_size: int, dilation: int, n: int = 2,
                 norm_type: str = "ln", c_multiple: int = 2, dropout: float = 0.0):
        super().__init__()
        self.kernel_size, self.dropout = kernel_size, dropout
        self.blocks = nn.ModuleList(
            nn.Sequential(make_norm(norm_type, channels),
                          nn.Conv1d(channels, c_multiple * channels, kernel_size,
                                    dilation=dilation),
                          nn.Identity(),     # the reference's k^-0.5 scale
                          nn.GELU(),
                          nn.Conv1d(c_multiple * channels, channels, 1))
            for _ in range(n))

    def forward(self, x: torch.Tensor, nonpadding: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        for norm, conv, _, _, proj in self.blocks:
            # the norm's output is masked before the conv, so a padded frame
            # reads as zeros in its neighbours' windows
            h = conv_same(conv, norm(x) * nonpadding) * weak(self.kernel_size ** -0.5, x)
            h = conv_same(proj, gelu(h))
            if train and self.dropout > 0:
                h = drop(h, self.dropout, generator)
            x = (x + h) * nonpadding
        return x


class ConvBlocks(nn.Module):
    """Residual blocks at ``dilations``, a last norm and a post conv. Its
    parameters sit on the module that owns it in the reference
    (``res_blocks``, ``last_norm``, ``post_net1``)."""

    def __init__(self, hidden_size: int, out_dims: int, dilations: Sequence[int],
                 kernel_size: int, norm_type: str = "ln", layers_in_block: int = 2,
                 c_multiple: int = 2, post_net_kernel: int = 3, dropout: float = 0.0):
        super().__init__()
        self.res_blocks = nn.ModuleList(
            ResidualBlock(hidden_size, kernel_size, d, n=layers_in_block,
                          norm_type=norm_type, c_multiple=c_multiple, dropout=dropout)
            for d in dilations)
        self.last_norm = make_norm(norm_type, hidden_size)
        self.post_net1 = nn.Conv1d(hidden_size, out_dims, post_net_kernel)

    def forward(self, x: torch.Tensor, nonpadding: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """x [B, T, H]; nonpadding [B, T, 1]."""
        for block in self.res_blocks:
            x = block(x, nonpadding, train, generator)
        x = self.last_norm(x * nonpadding) * nonpadding
        return conv_same(self.post_net1, x) * nonpadding


class TextConvEncoder(ConvBlocks):
    """sqrt(hidden)-scaled token embedding, then :class:`ConvBlocks`."""

    def __init__(self, vocab_size: int, hidden_size: int, out_dims: int,
                 dilations: Sequence[int], kernel_size: int, norm_type: str = "ln",
                 layers_in_block: int = 2, post_net_kernel: int = 3):
        super().__init__(hidden_size, out_dims, dilations, kernel_size, norm_type,
                         layers_in_block, post_net_kernel=post_net_kernel)
        self.hidden_size = hidden_size
        self.embed_tokens = TokenEmbedding(vocab_size, hidden_size)

    def forward(self, txt_tokens: torch.Tensor) -> torch.Tensor:
        """txt_tokens [B, S] -> [B, S, out_dims], zero at padding."""
        x = self.embed_tokens(txt_tokens)
        x = weak(math.sqrt(self.hidden_size), x) * x
        nonpadding = (txt_tokens != 0)[:, :, None].to(x.dtype)
        return super().forward(x, nonpadding)


class ConditionalConvBlocks(ConvBlocks):
    """:class:`ConvBlocks` over ``x`` plus a 3-wide conv (``g_prenet``) of a
    condition [B, T, c_cond]; ``nonpadding`` defaults to the frames of
    ``x`` with any non-zero feature."""

    def __init__(self, hidden_size: int, c_cond: int, out_dims: int,
                 dilations: Sequence[int], kernel_size: int, norm_type: str = "ln",
                 layers_in_block: int = 2, dropout: float = 0.0):
        super().__init__(hidden_size, out_dims, dilations, kernel_size, norm_type,
                         layers_in_block, dropout=dropout)
        self.g_prenet = nn.Conv1d(c_cond, hidden_size, 3)

    def forward(self, x: torch.Tensor, cond: torch.Tensor,
                nonpadding: torch.Tensor | None = None, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if nonpadding is None:
            nonpadding = (x.abs().sum(-1, keepdim=True) > 0).to(x.dtype)
        x = (x + conv_same(self.g_prenet, cond)) * nonpadding
        return super().forward(x, nonpadding, train, generator)
