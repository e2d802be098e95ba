"""Tacotron-style recurrent modules: ``PreNet``, ``HighwayNetwork``, a
bidirectional GRU, ``CBHG``, and the ``tacotron`` / ``tacotron2`` text
encoders and the ``rnn`` mel decoder of FastSpeech. Tensors are
``[B, T, C]``.

The recurrence is ``torch.nn.GRU`` (cuDNN on the card), over the whole
padded length in both directions, as the JAX package scans it. flax's
``GRUCell`` biases its three input projections and only the candidate's
recurrent one; ``nn.GRU``'s ``bias_hh`` for the reset and update gates is
then zero (``utils/convert_jax_params.py::_gru``), and the cell computes
the same function. Convolutions are SAME (flax's split of an even kernel's
padding), the norms LayerNorm at flax's epsilon, 1e-6. In training
(``train=True``) dropout draws its masks from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from speech_editing_tpu_torch.modules.conv import conv_same
from speech_editing_tpu_torch.modules.predictors import dropout as drop

LN_EPS = 1e-6      # flax nn.LayerNorm's default


def _drop(x, rate: float, train: bool, generator):
    return drop(x, rate, generator) if train and rate > 0 else x


class PreNet(nn.Module):
    """Two ReLU dense layers, each followed by dropout in training."""

    def __init__(self, in_dim: int, fc1_dim: int = 256, fc2_dim: int = 128,
                 dropout: float = 0.5):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, fc1_dim)
        self.fc2 = nn.Linear(fc1_dim, fc2_dim)
        self.dropout = dropout

    def forward(self, x, train: bool = False, generator=None):
        x = _drop(torch.relu(self.fc1(x)), self.dropout, train, generator)
        return _drop(torch.relu(self.fc2(x)), self.dropout, train, generator)


class HighwayNetwork(nn.Module):
    """g * relu(W1 x) + (1 - g) * x, g = sigmoid(W2 x)."""

    def __init__(self, size: int):
        super().__init__()
        self.W1 = nn.Linear(size, size)
        self.W2 = nn.Linear(size, size)

    def forward(self, x):
        g = torch.sigmoid(self.W2(x))
        return g * torch.relu(self.W1(x)) + (1.0 - g) * x


class BiGRU(nn.GRU):
    """[B, T, in] -> [B, T, 2 * hidden]: forward and backward states."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__(in_dim, hidden, batch_first=True, bidirectional=True)

    def forward(self, x):
        return super().forward(x)[0]


class CBHG(nn.Module):
    """A bank of SAME convs of widths 1..``bank_k`` (each LayerNorm, ReLU),
    a width-2 max pool, two projections, a residual add, highways and a
    bidirectional GRU."""

    def __init__(self, in_dim: int, bank_k: int, channels: int, proj_channels: tuple,
                 num_highways: int = 4):
        super().__init__()
        self.bank = nn.ModuleList(nn.Conv1d(in_dim, channels, k) for k in range(1, bank_k + 1))
        self.bank_norm = nn.ModuleList(nn.LayerNorm(channels, eps=LN_EPS)
                                       for _ in range(bank_k))
        self.proj1 = nn.Conv1d(bank_k * channels, proj_channels[0], 3)
        self.proj1_norm = nn.LayerNorm(proj_channels[0], eps=LN_EPS)
        self.proj2 = nn.Conv1d(proj_channels[0], proj_channels[1], 3)
        self.proj2_norm = nn.LayerNorm(proj_channels[1], eps=LN_EPS)
        self.pre_highway = (nn.Linear(proj_channels[1], in_dim)
                            if proj_channels[1] != in_dim else None)
        self.highways = nn.ModuleList(HighwayNetwork(in_dim) for _ in range(num_highways))
        self.rnn = BiGRU(in_dim, channels)

    def forward(self, x):
        residual = x
        y = torch.cat([torch.relu(norm(conv_same(conv, x)))
                       for conv, norm in zip(self.bank, self.bank_norm)], -1)
        # width 2, stride 1, SAME: the last frame's window is itself alone
        y = F.pad(y.transpose(1, 2), (0, 1), value=float("-inf"))
        y = F.max_pool1d(y, 2, 1).transpose(1, 2)
        y = torch.relu(self.proj1_norm(conv_same(self.proj1, y)))
        y = self.proj2_norm(conv_same(self.proj2, y))
        if self.pre_highway is not None:
            y = self.pre_highway(y)
        y = y + residual
        for highway in self.highways:
            y = highway(y)
        return self.rnn(y)


class TacotronEncoder(nn.Module):
    """Embedding -> PreNet -> CBHG -> projection, zero at padding tokens."""

    def __init__(self, vocab_size: int, hidden_size: int):
        super().__init__()
        h = hidden_size
        self.embedding = nn.Embedding(vocab_size, h)
        self.pre_net = PreNet(h, h, h // 2)
        self.cbhg = CBHG(h // 2, bank_k=16, channels=h // 2, proj_channels=(h // 2, h // 2))
        self.proj_out = nn.Linear(h, h)

    def forward(self, txt_tokens, train: bool = False, generator=None):
        x = self.pre_net(self.embedding(txt_tokens), train, generator)
        x = self.proj_out(self.cbhg(x))
        return x * (txt_tokens > 0)[:, :, None].to(x.dtype)


class RNNEncoder(nn.Module):
    """Tacotron 2's encoder: embedding -> 3 x (SAME conv, LayerNorm, ReLU,
    dropout 0.5) -> bidirectional GRU, zero at padding tokens."""

    def __init__(self, vocab_size: int, hidden_size: int):
        super().__init__()
        h = hidden_size
        self.embedding = nn.Embedding(vocab_size, h)
        self.convs = nn.ModuleList(nn.Conv1d(h, h, 5) for _ in range(3))
        self.norms = nn.ModuleList(nn.LayerNorm(h, eps=LN_EPS) for _ in range(3))
        self.rnn = BiGRU(h, h // 2)

    def forward(self, txt_tokens, train: bool = False, generator=None):
        x = self.embedding(txt_tokens)
        for conv, norm in zip(self.convs, self.norms):
            x = _drop(torch.relu(norm(conv_same(conv, x))), 0.5, train, generator)
        x = self.rnn(x)
        return x * (txt_tokens > 0)[:, :, None].to(x.dtype)


class DecoderRNN(nn.Module):
    """FastSpeech's ``rnn`` decoder: two bidirectional GRUs and a
    projection back to ``hidden_size``."""

    def __init__(self, hidden_size: int):
        super().__init__()
        h = hidden_size
        self.rnn1 = BiGRU(h, h // 2)
        self.rnn2 = BiGRU(2 * (h // 2), h // 2)
        self.proj = nn.Linear(2 * (h // 2), h)

    def forward(self, x):
        return self.proj(self.rnn2(self.rnn1(x)))
