"""Glow-TTS's relative-window transformer encoder, FastSpeech's
``encoder_type: rel_fft``: an optional ``ConvReluNorm`` prenet, then
pre-LN layers of multi-head attention with learned relative key and value
embeddings clamped to a window of +-``window_size`` and a conv FFN.

Plain PyTorch, as in the JAX package, which runs it outside any kernel:
the windowed relative attention adds to the logits and reads the
probabilities, which K3 keeps inside. Norms are LayerNorm at flax's
epsilon, 1e-6.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from speech_editing_tpu_torch.modules.conv import conv_same
from speech_editing_tpu_torch.modules.rnn import LN_EPS, _drop


class ConvReluNorm(nn.Module):
    """``n_layers`` x (SAME conv of the masked input, LayerNorm, ReLU,
    dropout), a zero-initialised projection, and a residual add."""

    def __init__(self, hidden_size: int, kernel_size: int = 5, n_layers: int = 3,
                 dropout: float = 0.0):
        super().__init__()
        self.convs = nn.ModuleList(nn.Conv1d(hidden_size, hidden_size, kernel_size)
                                   for _ in range(n_layers))
        self.norms = nn.ModuleList(nn.LayerNorm(hidden_size, eps=LN_EPS)
                                   for _ in range(n_layers))
        self.proj = nn.Linear(hidden_size, hidden_size)
        self.dropout = dropout

    def forward(self, x, mask, train: bool = False, generator=None):
        out = x
        for conv, norm in zip(self.convs, self.norms):
            out = torch.relu(norm(conv_same(conv, out * mask)))
            out = _drop(out, self.dropout, train, generator)
        return (x + self.proj(out)) * mask


class RelWindowAttention(nn.Module):
    """Attention whose logits add q . emb_rel_k[clip(s - t, -w, w) + w] and
    whose output adds sum_s p . emb_rel_v[...] (same clipped distance)."""

    def __init__(self, hidden_size: int, num_heads: int = 2, window_size: int = 4):
        super().__init__()
        h, d = hidden_size, hidden_size // num_heads
        self.num_heads, self.window_size = num_heads, window_size
        self.q, self.k, self.v, self.out = (nn.Linear(h, h) for _ in range(4))
        self.emb_rel_k = nn.Parameter(torch.randn(2 * window_size + 1, d) * d ** -0.5)
        self.emb_rel_v = nn.Parameter(torch.randn(2 * window_size + 1, d) * d ** -0.5)

    def forward(self, x, attn_mask):
        """x [B, T, H]; attn_mask [B, T, T], > 0 where a query may see a key."""
        b, t, hid = x.shape
        nh, w = self.num_heads, self.window_size
        d = hid // nh
        heads = lambda y: y.reshape(b, t, nh, d).transpose(1, 2)
        q, k, v = heads(self.q(x)), heads(self.k(x)), heads(self.v(x))
        scale = math.sqrt(d)
        scores = torch.einsum("bhtd,bhsd->bhts", q, k) / scale
        pos = torch.arange(t, device=x.device)
        dist = (pos[None, :] - pos[:, None]).clamp(-w, w) + w          # [T, T] in [0, 2w]
        rel_logits = torch.einsum("bhtd,nd->bhtn", q, self.emb_rel_k) / scale
        scores = scores + torch.gather(rel_logits, -1, dist.expand(b, nh, t, t))
        scores = torch.where(attn_mask[:, None] > 0, scores, torch.full_like(scores, -1e9))
        p = torch.softmax(scores, -1)
        out = torch.einsum("bhts,bhsd->bhtd", p, v)
        out = out + torch.einsum("bhts,tsd->bhtd", p, self.emb_rel_v[dist])
        return self.out(out.transpose(1, 2).reshape(b, t, hid))


class RelTransformerEncoder(nn.Module):
    """Token ids [B, S] (or embedded states [B, S, H], padding where all
    features are zero) -> [B, S, H], zero at padding."""

    def __init__(self, vocab_size: int, hidden_size: int, num_layers: int = 6,
                 kernel_size: int = 3, num_heads: int = 2, window_size: int = 4,
                 dropout: float = 0.0, prenet: bool = True):
        super().__init__()
        h = self.hidden_size = hidden_size
        self.dropout = dropout
        self.emb = nn.Embedding(vocab_size, h) if vocab_size else None
        self.pre = ConvReluNorm(h, 5, 3, dropout) if prenet else None
        self.attn = nn.ModuleList(RelWindowAttention(h, num_heads, window_size)
                                  for _ in range(num_layers))
        self.norm1 = nn.ModuleList(nn.LayerNorm(h, eps=LN_EPS) for _ in range(num_layers))
        self.norm2 = nn.ModuleList(nn.LayerNorm(h, eps=LN_EPS) for _ in range(num_layers))
        self.ffn1 = nn.ModuleList(nn.Conv1d(h, 4 * h, kernel_size) for _ in range(num_layers))
        self.ffn2 = nn.ModuleList(nn.Conv1d(4 * h, h, kernel_size) for _ in range(num_layers))
        self.last_norm = nn.LayerNorm(h, eps=LN_EPS)

    def forward(self, tokens_or_hidden, train: bool = False, generator=None):
        if tokens_or_hidden.dim() == 2:
            x = self.emb(tokens_or_hidden) * self.hidden_size ** 0.5
            mask = (tokens_or_hidden > 0)[:, :, None].to(x.dtype)
        else:
            x = tokens_or_hidden
            mask = (x.abs().sum(-1, keepdim=True) > 0).to(x.dtype)
        attn_mask = mask[:, :, 0][:, None, :] * mask[:, :, 0][:, :, None]
        if self.pre is not None:
            x = self.pre(x, mask, train, generator)
        for attn, norm1, norm2, ffn1, ffn2 in zip(self.attn, self.norm1, self.norm2,
                                                 self.ffn1, self.ffn2):
            y = attn(norm1(x) * mask, attn_mask)
            x = (x + _drop(y, self.dropout, train, generator)) * mask
            y = torch.relu(conv_same(ffn1, norm2(x) * mask))
            y = conv_same(ffn2, y * mask)
            x = (x + _drop(y, self.dropout, train, generator)) * mask
        return self.last_norm(x) * mask
