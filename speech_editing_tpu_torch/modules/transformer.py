"""FFT blocks (self-attention + conv-FFN layers): the FFT text encoder
(token embedding, sinusoidal positions), FastSpeech's mel decoder (learned-
alpha positions); and CampNet's cross-attending mel decoder
(``TransformerDecoder`` of ``DecSALayer``s). Tensors are ``[B, T, C]``;
parameter names follow the reference torch modules
(``layers.{i}.op.self_attn.in_proj_weight``, a causal FFN's conv under
``ffn.ffn_1.1`` and so on)."""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from speech_editing_tpu_torch.ops.flash_attention import NEG_INF, flash_mha, flash_mha_train
from speech_editing_tpu_torch.ops.seq_ops import make_positions
from speech_editing_tpu_torch.utils.dtypes import gelu, weak, widen


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
    """Bias-free attention with packed q/k/v projections. Without a weight
    readout the softmax attention is kernel K3 (``flash_mha``), and its
    backward, when autograd records, kernel K4 (``flash_mha_train``); with
    ``return_weights`` it is the plain einsum, which also returns the
    probabilities [B, h, Tq, Tk] (float32), as the JAX package's einsum
    branch does. In bf16 (``use_bf16``) K3 and K4 take their bf16 forms."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.out_proj = nn.Linear(dim, dim, bias=False)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, query: torch.Tensor, key_padding_mask: torch.Tensor | None = None,
                *, key: torch.Tensor | None = None, return_weights: bool = False):
        """``key_padding_mask`` bool [B, Tk], True at pad keys; ``key``
        (keys and values, [B, Tk, E]) defaults to ``query``."""
        kv = query if key is None else key
        b, tq, e = query.shape
        tk = kv.shape[1]
        h, d = self.num_heads, e // self.num_heads
        w = self.in_proj_weight
        q = F.linear(query, w[:e]).view(b, tq, h, d)
        q = q * weak(d ** -0.5, q)
        k = F.linear(kv, w[e:2 * e]).view(b, tk, h, d)
        v = F.linear(kv, w[2 * e:]).view(b, tk, h, d)
        if return_weights:
            # logits and weights in f32 (from bf16 q, k under use_bf16, as
            # JAX's preferred_element_type forms them); the weights meet v
            # in its dtype
            logits = torch.einsum("bqhd,bkhd->bhqk", widen(q), widen(k))
            if key_padding_mask is not None:
                logits = logits + torch.where(key_padding_mask, NEG_INF, 0.0)[:, None, None, :]
            weights = torch.softmax(logits, dim=-1)
            out = torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype), v)
            return self.out_proj(out.reshape(b, tq, e)), weights
        attend = flash_mha_train if torch.is_grad_enabled() else flash_mha
        out = attend(q, k, v, key_padding_mask)
        return self.out_proj(out.reshape(b, tq, e))


class ConvFFN(nn.Module):
    """k-wide conv up-projection (output scaled by k^-0.5), exact GELU, and
    a linear down-projection; ``padding`` "SAME" ((k-1)//2, k//2) or
    "LEFT" (k - 1 frames before: causal, the conv then at ``ffn_1.1``)."""

    def __init__(self, hidden_size: int, filter_size: int, kernel_size: int,
                 padding: str = "SAME"):
        super().__init__()
        if padding not in ("SAME", "LEFT"):
            raise ValueError(f"ConvFFN: padding {padding!r} is not SAME or LEFT")
        self.kernel_size, self.padding = kernel_size, padding
        conv = nn.Conv1d(hidden_size, filter_size, kernel_size)
        self.ffn_1 = conv if padding == "SAME" else nn.Sequential(
            nn.ConstantPad1d((kernel_size - 1, 0), 0.0), conv)
        self.ffn_2 = nn.Linear(filter_size, hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel_size
        y = x.transpose(1, 2)
        if self.padding == "SAME":
            y = F.pad(y, ((k - 1) // 2, k // 2))
        y = self.ffn_1(y).transpose(1, 2)
        y = y * weak(k ** -0.5, y)
        return self.ffn_2(gelu(y))


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


def _recomputed(layer: nn.Module, x: torch.Tensor, padding_mask: torch.Tensor,
                nonpad: torch.Tensor) -> torch.Tensor:
    """``layer(x, padding_mask) * nonpad`` keeping none of the layer's
    activations for the backward, which runs the layer again (the JAX
    package's ``nn.remat(body, prevent_cse=False)``): K3 twice and K4 once.
    The rerun takes the parameters the layer holds now, captured here:
    under ``use_bf16`` those are the bf16 copies that ``functional_call``
    swapped in, which it has swapped out again by the time the backward
    runs. The layer draws no random numbers, so no RNG state is kept."""
    params = dict(layer.named_parameters())
    run = lambda x, params: functional_call(layer, params, (x, padding_mask)) * nonpad
    return checkpoint(run, x, params, use_reentrant=False, preserve_rng_state=False)


class FFTBlocks(nn.Module):
    """``EncSALayer``s over [B, T, H], the input re-masked after each, and a
    last LayerNorm (``use_last_norm``); with ``use_pos_embed``, sinusoidal
    positions over the frames that are not padding are added first, scaled
    by the learned ``pos_embed_alpha``. ``padding_mask`` [B, T] (True at
    padding) defaults to the frames whose features are all zero. With
    ``remat`` (``remat_fft``) each layer is recomputed in the backward
    (:func:`_recomputed`)."""

    def __init__(self, hidden_size: int, num_layers: int, ffn_kernel_size: int = 9,
                 num_heads: int = 2, use_pos_embed: bool = True, use_last_norm: bool = True,
                 remat: bool = False):
        super().__init__()
        self.hidden_size, self.use_pos_embed, self.remat = hidden_size, use_pos_embed, remat
        if use_pos_embed:
            self.pos_embed_alpha = nn.Parameter(torch.ones(1))
        self.layers = nn.ModuleList(
            _Op(EncSALayer(hidden_size, num_heads, ffn_kernel_size))
            for _ in range(num_layers))
        self.layer_norm = nn.LayerNorm(hidden_size, eps=1e-5) if use_last_norm else None

    def forward(self, x: torch.Tensor, padding_mask: torch.Tensor | None = None) -> torch.Tensor:
        if padding_mask is None:
            padding_mask = x.abs().sum(-1) == 0
        nonpad = (~padding_mask)[:, :, None].to(x.dtype)
        if self.use_pos_embed:
            positions = sinusoidal_positional_embedding((~padding_mask).long(), self.hidden_size)
            x = x + self.pos_embed_alpha * positions.to(x.dtype)
        x = x * nonpad
        remat = self.remat and torch.is_grad_enabled()
        for layer in self.layers:
            x = (_recomputed(layer.op, x, padding_mask, nonpad) if remat
                 else layer.op(x, padding_mask) * nonpad)
        return x if self.layer_norm is None else self.layer_norm(x) * nonpad


class FastSpeechEncoder(FFTBlocks):
    """Scaled token embedding + positions + EncSALayers + last LayerNorm."""

    def __init__(self, vocab_size: int, hidden_size: int = 256,
                 num_layers: int = 4, kernel_size: int = 9, num_heads: int = 2,
                 remat: bool = False):
        super().__init__(hidden_size, num_layers, kernel_size, num_heads, use_pos_embed=False,
                         remat=remat)
        self.embed_tokens = TokenEmbedding(vocab_size, hidden_size)
        nn.init.normal_(self.embed_tokens.weight, std=hidden_size ** -0.5)

    def forward(self, txt_tokens: torch.Tensor) -> torch.Tensor:
        padding_mask = txt_tokens == 0
        x = self.embed_tokens(txt_tokens)
        x = weak(math.sqrt(self.hidden_size), x) * x
        # the float32 table casts to x's dtype at the add, as in JAX
        x = x + sinusoidal_positional_embedding(txt_tokens, self.hidden_size).to(x.dtype)
        return super().forward(x, padding_mask)


class FastSpeechDecoder(FFTBlocks):
    """FastSpeech's mel decoder: :class:`FFTBlocks` with learned-alpha
    positions, over frames whose padding is read from the input. On the
    card its self-attention is K3 (K4 under autograd) over mel frames."""


class DecSALayer(nn.Module):
    """Pre-LN self-attention (K3), cross-attention over the encoder output
    (the plain einsum: its weights are read out) and a causal conv-FFN.
    Returns (x, cross-attention weights [B, h, Tq, Tk])."""

    def __init__(self, dim: int, num_heads: int, kernel_size: int):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.self_attn = MultiheadAttention(dim, num_heads)
        self.layer_norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.encoder_attn = MultiheadAttention(dim, num_heads)
        self.layer_norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ffn = ConvFFN(dim, 4 * dim, kernel_size, "LEFT")

    def forward(self, x, encoder_out, encoder_padding_mask=None,
                self_attn_padding_mask=None):
        x = x + self.self_attn(self.layer_norm1(x), self_attn_padding_mask)
        h, weights = self.encoder_attn(self.layer_norm2(x), encoder_padding_mask,
                                       key=encoder_out, return_weights=True)
        x = x + h
        return x + self.ffn(self.layer_norm3(x)), weights


class TransformerDecoder(nn.Module):
    """CampNet's cross-attending mel decoder: learned-alpha sinusoidal
    positions over the frames that are not padding, ``DecSALayer``s
    re-masked after each, a last LayerNorm. Returns (x, the first layer's
    cross-attention weights averaged over heads [B, Tq, Tk])."""

    def __init__(self, hidden_size: int, num_layers: int, ffn_kernel_size: int = 9,
                 num_heads: int = 2):
        super().__init__()
        self.hidden_size = hidden_size
        self.pos_embed_alpha = nn.Parameter(torch.ones(1))
        self.layers = nn.ModuleList(
            _Op(DecSALayer(hidden_size, num_heads, ffn_kernel_size))
            for _ in range(num_layers))
        self.layer_norm = nn.LayerNorm(hidden_size, eps=1e-5)

    def forward(self, x, encoder_out, encoder_padding_mask=None,
                self_attn_padding_mask=None, padding_mask=None):
        """``padding_mask`` [B, T] bool (True at padded frames) defaults to
        the frames whose features are all zero."""
        if padding_mask is None:
            padding_mask = x.abs().sum(-1) == 0
        nonpad = (~padding_mask)[:, :, None].to(x.dtype)
        positions = sinusoidal_positional_embedding((~padding_mask).long(), self.hidden_size)
        x = (x + self.pos_embed_alpha * positions.to(x.dtype)) * nonpad
        attn = None
        for layer in self.layers:
            x, weights = layer.op(x, encoder_out, encoder_padding_mask, self_attn_padding_mask)
            x = x * nonpad
            if attn is None:
                attn = weights.mean(dim=1)
        return self.layer_norm(x) * nonpad, attn
