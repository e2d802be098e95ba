"""Plain PyTorch reference of the ``campnet`` configuration: CampNet (Wang et
al., ICASSP 2022) as configured by ``configs/campnet.json``: a 3-layer
pre-LN transformer text encoder, the masked mel frames replaced by a learned
``mask_emb``, a 6-layer coarse decoder (frame self-attention over the
frames, cross-attention over the text, a causal conv-FFN), a residual conv
fine decoder over the coarse-composited mel; and its training loss (l1 and
ssim, 0.5 each, of the coarse and the fine mel inside the mask). float32,
attention as an explicit softmax; parameter names are the published torch
module's. Imports no code of the program."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.fluentspeech import (Embedding, ResidualBlock, _wmean, conv_same,
                                              ssim_map)


def positions(nonpad: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embeddings [sin | cos] of positions 1, 2, ... over the
    entries of ``nonpad`` [B, T] (long), zero at padding."""
    pos = torch.cumsum(nonpad, dim=1) * nonpad
    half = dim // 2
    freq = torch.exp(torch.arange(half, dtype=torch.float64) * -(math.log(10000) / (half - 1)))
    table = torch.cat([torch.sin(torch.arange(pos.shape[1] + 1, dtype=torch.float64)[:, None]
                                 * freq), torch.cos(torch.arange(pos.shape[1] + 1,
                                                                 dtype=torch.float64)[:, None]
                                                    * freq)], 1).float()
    table[0] = 0
    return table.to(nonpad.device)[pos]


class Attention(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.out_proj = nn.Linear(dim, dim, bias=False)

    def forward(self, x, pad, kv=None, weights=False):
        kv = x if kv is None else kv
        b, tq, e = x.shape
        h, d = self.heads, e // self.heads
        w = self.in_proj_weight
        q = F.linear(x, w[:e]).view(b, tq, h, d) * d ** -0.5
        k = F.linear(kv, w[e:2 * e]).view(b, -1, h, d)
        v = F.linear(kv, w[2 * e:]).view(b, -1, h, d)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if pad is not None:
            logits = logits.masked_fill(pad[:, None, None, :], float("-inf"))
        p = torch.softmax(logits, dim=-1)
        if pad is not None:   # a row with no valid key attends to nothing
            p = torch.nan_to_num(p, nan=0.0)
        out = self.out_proj(torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, tq, e))
        return (out, p) if weights else out


class FFN(nn.Module):
    def __init__(self, dim, k, causal):
        super().__init__()
        self.k, self.causal = k, causal
        conv = nn.Conv1d(dim, 4 * dim, k)
        self.ffn_1 = nn.Sequential(nn.ConstantPad1d((k - 1, 0), 0.0), conv) if causal else conv
        self.ffn_2 = nn.Linear(4 * dim, dim)

    def forward(self, x):
        y = x.transpose(1, 2)
        if not self.causal:
            y = F.pad(y, ((self.k - 1) // 2, self.k // 2))
        return self.ffn_2(F.gelu(self.ffn_1(y).transpose(1, 2) * self.k ** -0.5))


class EncLayer(nn.Module):
    def __init__(self, dim, heads, k):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.self_attn = Attention(dim, heads)
        self.layer_norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.ffn = FFN(dim, k, False)

    def forward(self, x, pad):
        keep = (~pad)[:, :, None].float()
        x = (x + self.self_attn(self.layer_norm1(x), pad)) * keep
        return (x + self.ffn(self.layer_norm2(x) * keep)) * keep


class DecLayer(nn.Module):
    def __init__(self, dim, heads, k):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.self_attn = Attention(dim, heads)
        self.layer_norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.encoder_attn = Attention(dim, heads)
        self.layer_norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ffn = FFN(dim, k, True)

    def forward(self, x, enc, enc_pad, pad):
        x = x + self.self_attn(self.layer_norm1(x), pad)
        x = x + self.encoder_attn(self.layer_norm2(x), enc_pad, kv=enc)
        return x + self.ffn(self.layer_norm3(x))


class _Op(nn.Module):
    def __init__(self, op):
        super().__init__()
        self.op = op


class Encoder(nn.Module):
    def __init__(self, vocab, dim, layers, k, heads):
        super().__init__()
        self.dim = dim
        self.layers = nn.ModuleList(_Op(EncLayer(dim, heads, k)) for _ in range(layers))
        self.layer_norm = nn.LayerNorm(dim, eps=1e-5)
        self.embed_tokens = Embedding(vocab, dim)

    def forward(self, tokens):
        pad = tokens == 0
        keep = (~pad)[:, :, None].float()
        x = self.embed_tokens(tokens) * math.sqrt(self.dim) + positions((~pad).long(), self.dim)
        x = x * keep
        for layer in self.layers:
            x = layer.op(x, pad) * keep
        return self.layer_norm(x) * keep


class Decoder(nn.Module):
    def __init__(self, dim, layers, k, heads):
        super().__init__()
        self.dim = dim
        self.pos_embed_alpha = nn.Parameter(torch.ones(1))
        self.layers = nn.ModuleList(_Op(DecLayer(dim, heads, k)) for _ in range(layers))
        self.layer_norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x, enc, enc_pad, pad):
        keep = (~pad)[:, :, None].float()
        x = (x + self.pos_embed_alpha * positions((~pad).long(), self.dim)) * keep
        for layer in self.layers:
            x = layer.op(x, enc, enc_pad, pad) * keep
        return self.layer_norm(x) * keep


class ConvBlocks(nn.Module):
    def __init__(self, dim, n_blocks, k, n):
        super().__init__()
        self.res_blocks = nn.ModuleList(ResidualBlock(dim, k, 1, n) for _ in range(n_blocks))
        self.last_norm = nn.LayerNorm(dim, eps=1e-5)
        self.post_net1 = nn.Conv1d(dim, dim, 3)

    def forward(self, x, keep):
        for block in self.res_blocks:
            x = block(x, keep)
        return conv_same(self.post_net1, self.last_norm(x * keep) * keep) * keep


class MelEncoder(nn.Module):
    def __init__(self, h):
        super().__init__()
        self.encoder = nn.Sequential(nn.Linear(80, h), nn.ReLU(), nn.Linear(h, h), nn.ReLU())
        self.fc_out = nn.Linear(h, h)

    def forward(self, mel):
        return self.fc_out(self.encoder(mel))


class CampNet(nn.Module):
    def __init__(self, vocab, hp):
        super().__init__()
        h, k = hp["hidden_size"], hp["dec_ffn_kernel_size"]
        self.encoder = Encoder(vocab, h, 3, k, 2)
        self.mel_encoder = MelEncoder(h)
        self.decoder_coarse = Decoder(h, 6, k, 2)
        self.decoder_fine = ConvBlocks(h, 5, 5, hp["layers_in_block"])
        self.mel_out_coarse = nn.Linear(h, 80, bias=False)
        self.mel_out_fine = nn.Linear(h, 80, bias=False)
        self.mask_emb = nn.Parameter(torch.zeros(1, 1, 80))

    def forward(self, tokens, mels, tm):
        """tokens [B, S]; mels [B, T, 80] (zero rows at padding); tm [B, T, 1]."""
        enc = self.encoder(tokens) * (tokens > 0)[:, :, None].float()
        keep = (mels.abs().sum(-1) > 0).float()[:, :, None]
        pad = keep[..., 0] == 0
        coarse_in = self.mel_encoder(mels * (1 - tm) + self.mask_emb * tm) * keep
        coarse = self.mel_out_coarse(self.decoder_coarse(coarse_in, enc, tokens == 0, pad)
                                     * keep) * keep
        mel_coarse = mels * (1 - tm) + coarse * tm
        fine_in = self.mel_encoder(mel_coarse) * keep
        fine_keep = (fine_in.abs().sum(-1, keepdim=True) > 0).float()
        fine = self.decoder_fine(fine_in, fine_keep) * keep
        return {"mel_out_coarse": coarse,
                "mel_out_fine": mel_coarse + self.mel_out_fine(fine) * keep * tm}


def loss_terms(model: CampNet, batch, generator=None):
    """l1 and ssim (0.5 each) of the coarse and the fine mel inside the mask."""
    tm = batch["time_mel_masks"][..., None]
    out = model(batch["txt_tokens"], batch["mels"], tm)
    tgt = batch["mels"] * tm
    w = (tgt.abs().sum(-1, keepdim=True) != 0).float().expand_as(tgt)
    terms = {}
    for name in ("coarse", "fine"):
        pred = out[f"mel_out_{name}"] * tm
        terms[f"l1_{name}"] = _wmean((pred - tgt).abs(), w) * 0.5
        terms[f"ssim_{name}"] = _wmean(1.0 - ssim_map(pred + 6.0, tgt + 6.0), w) * 0.5
    return sum(terms.values()), terms

