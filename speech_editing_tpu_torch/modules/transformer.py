"""FFT text encoder: token embedding, sinusoidal positions, self-attention +
conv-FFN layers. Tensors are ``[B, T, C]``; parameter names follow the
reference torch FastSpeech encoder (``layers.{i}.op.self_attn.in_proj_weight``
and so on)."""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from speech_editing_tpu_torch.ops.flash_attention import flash_mha, flash_mha_train
from speech_editing_tpu_torch.ops.seq_ops import make_positions


class TokenEmbedding(nn.Embedding):
    """Embedding whose padding id gives a zero row."""

    def __init__(self, vocab_size: int, dim: int, padding_idx: int = 0):
        super().__init__(vocab_size, dim)
        self.pad_id = padding_idx

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return super().forward(tokens) * (tokens != self.pad_id)[..., None]


def sinusoidal_embedding_table(num_positions: int, dim: int,
                               padding_idx: int | None = 0) -> np.ndarray:
    """[sin(all) | cos(all)] concatenated (not interleaved), float32."""
    half = dim // 2
    freq = np.exp(np.arange(half, dtype=np.float64) * -(math.log(10000) / (half - 1)))
    ang = np.arange(num_positions, dtype=np.float64)[:, None] * freq[None, :]
    table = np.concatenate([np.sin(ang), np.cos(ang)], axis=1)
    if dim % 2 == 1:
        table = np.concatenate([table, np.zeros((num_positions, 1))], axis=1)
    if padding_idx is not None:
        table[padding_idx] = 0
    return table.astype(np.float32)


@functools.lru_cache(maxsize=16)
def _device_table(num_positions: int, dim: int, padding_idx: int,
                  device: torch.device) -> torch.Tensor:
    return torch.from_numpy(
        sinusoidal_embedding_table(num_positions, dim, padding_idx)).to(device)


def sinusoidal_positional_embedding(tokens: torch.Tensor, dim: int,
                                    padding_idx: int = 0) -> torch.Tensor:
    """Padding-aware sinusoidal position embedding of a [B, T] id tensor."""
    positions = make_positions(tokens, padding_idx)
    table = _device_table(padding_idx + 1 + tokens.shape[1], dim, padding_idx,
                          tokens.device)
    return table[positions]


class MultiheadAttention(nn.Module):
    """Bias-free self-attention with packed q/k/v projections; the softmax
    attention itself is kernel K3 (``flash_mha``), and its backward, when
    autograd records, kernel K4 (``flash_mha_train``)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.out_proj = nn.Linear(dim, dim, bias=False)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x: torch.Tensor,
                key_padding_mask: torch.Tensor | None = None) -> torch.Tensor:
        b, t, e = x.shape
        h, d = self.num_heads, e // self.num_heads
        w = self.in_proj_weight
        q = F.linear(x, w[:e]).view(b, t, h, d) * d ** -0.5
        k = F.linear(x, w[e:2 * e]).view(b, t, h, d)
        v = F.linear(x, w[2 * e:]).view(b, t, h, d)
        attend = flash_mha_train if torch.is_grad_enabled() else flash_mha
        out = attend(q, k, v, key_padding_mask)
        return self.out_proj(out.reshape(b, t, e))


class ConvFFN(nn.Module):
    """k-wide conv up-projection (output scaled by k^-0.5), exact GELU, and
    a linear down-projection; SAME padding ((k-1)//2, k//2)."""

    def __init__(self, hidden_size: int, filter_size: int, kernel_size: int):
        super().__init__()
        self.kernel_size = kernel_size
        self.ffn_1 = nn.Conv1d(hidden_size, filter_size, kernel_size)
        self.ffn_2 = nn.Linear(filter_size, hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel_size
        y = F.pad(x.transpose(1, 2), ((k - 1) // 2, k // 2))
        y = self.ffn_1(y).transpose(1, 2) * k ** -0.5
        return self.ffn_2(F.gelu(y))


class EncSALayer(nn.Module):
    """Pre-LN self-attention + conv-FFN encoder layer."""

    def __init__(self, dim: int, num_heads: int, kernel_size: int):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.self_attn = MultiheadAttention(dim, num_heads)
        self.layer_norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.ffn = ConvFFN(dim, 4 * dim, kernel_size)

    def forward(self, x: torch.Tensor, padding_mask: torch.Tensor) -> torch.Tensor:
        nonpad = (~padding_mask)[:, :, None].to(x.dtype)
        x = (x + self.self_attn(self.layer_norm1(x), padding_mask)) * nonpad
        return (x + self.ffn(self.layer_norm2(x) * nonpad)) * nonpad


class _Op(nn.Module):
    """Holds a layer as ``.op`` (the reference's TransformerEncoderLayer)."""

    def __init__(self, op: nn.Module):
        super().__init__()
        self.op = op


class FastSpeechEncoder(nn.Module):
    """Scaled token embedding + positions + EncSALayers + last LayerNorm."""

    def __init__(self, vocab_size: int, hidden_size: int = 256,
                 num_layers: int = 4, kernel_size: int = 9, num_heads: int = 2):
        super().__init__()
        self.hidden_size = hidden_size
        self.embed_tokens = TokenEmbedding(vocab_size, hidden_size)
        nn.init.normal_(self.embed_tokens.weight, std=hidden_size ** -0.5)
        self.layers = nn.ModuleList(
            _Op(EncSALayer(hidden_size, num_heads, kernel_size))
            for _ in range(num_layers))
        self.layer_norm = nn.LayerNorm(hidden_size, eps=1e-5)

    def forward(self, txt_tokens: torch.Tensor) -> torch.Tensor:
        padding_mask = txt_tokens == 0
        nonpad = (~padding_mask)[:, :, None].float()
        x = math.sqrt(self.hidden_size) * self.embed_tokens(txt_tokens)
        x = (x + sinusoidal_positional_embedding(txt_tokens, self.hidden_size)) * nonpad
        for layer in self.layers:
            x = layer.op(x, padding_mask) * nonpad
        return self.layer_norm(x) * nonpad
