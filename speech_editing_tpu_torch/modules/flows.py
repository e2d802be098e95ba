"""Normalizing flows over ``[B, T, C]``: the residual coupling flow
(``ResFlow``, PortaSpeech's prior) and the Glow post-flow (``Glow``,
PortaSpeech-flow's mel flow); the port of the JAX package's
``modules/flows.py``.

* :class:`ResFlow`: volume-preserving additive coupling steps (a ``WN`` on
  half the channels, conditioned on the other half and an outside
  condition), the channels flipped after each step; ``reverse`` undoes it
  exactly.
* :class:`Glow`: blocks of ActNorm, an invertible 1x1 product and a ``WN``
  affine coupling (its output layer zero at the start, so each block starts
  as the identity), with their log-determinants [B]; ``reverse`` samples.

No kernel of the port's runs here: ``WN`` is plain convolutions. The 1x1
product and its inverse run in float32 with TF32 off on the card (set by
``training/trainer.py::float32_on_card``), as JAX asks
``Precision.HIGHEST``, so that the reverse inverts the forward.
Parameter names: ``couplings.{i}.{pre,enc,post}``, ``actnorms.{i}.{logs,bias}``,
``invconvs.{i}.weight``.
"""

from __future__ import annotations

import torch
from torch import nn

from speech_editing_tpu_torch.modules.wavenet import WN


class _AdditiveCoupling(nn.Module):
    def __init__(self, channels: int, hidden_size: int, kernel_size: int, n_layers: int,
                 c_cond: int = 0):
        super().__init__()
        half = channels // 2
        self.pre = nn.Linear(half, hidden_size)
        self.enc = WN(hidden_size, kernel_size, 1, n_layers, c_cond)
        self.post = nn.Linear(hidden_size, half)

    def forward(self, x, nonpadding, cond=None, reverse: bool = False):
        half = x.shape[-1] // 2
        x0, x1 = x[..., :half], x[..., half:]
        h = self.enc(self.pre(x0) * nonpadding, nonpadding, cond)
        m = self.post(h)
        x1 = x1 - m if reverse else x1 + m
        return torch.cat([x0, x1], -1) * nonpadding


class ResFlow(nn.Module):
    """``n_flow_steps`` (coupling, channel flip) steps; ``reverse`` runs
    them backwards, undoing each flip first."""

    def __init__(self, c_in: int, hidden_size: int, kernel_size: int, n_flow_steps: int = 4,
                 n_flow_layers: int = 4, c_cond: int = 0):
        super().__init__()
        self.couplings = nn.ModuleList(
            _AdditiveCoupling(c_in, hidden_size, kernel_size, n_flow_layers, c_cond)
            for _ in range(n_flow_steps))

    def forward(self, x, nonpadding, cond=None, reverse: bool = False):
        if reverse:
            for coupling in reversed(self.couplings):
                x = coupling(torch.flip(x, [-1]), nonpadding, cond, reverse=True)
            return x
        for coupling in self.couplings:
            x = torch.flip(coupling(x, nonpadding, cond), [-1])
        return x


class _ActNorm(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.logs = nn.Parameter(torch.zeros(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, nonpadding, reverse: bool = False):
        if reverse:
            return (x - self.bias) * torch.exp(-self.logs) * nonpadding, None
        logdet = self.logs.sum() * nonpadding[..., 0].sum(-1)
        return (self.bias + torch.exp(self.logs) * x) * nonpadding, logdet


class _InvConv(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, channels))
        nn.init.orthogonal_(self.weight)      # |det| = 1 at the start

    def forward(self, x, nonpadding, reverse: bool = False):
        if reverse:
            w, logdet = torch.linalg.inv(self.weight), None
        else:
            w = self.weight
            logdet = torch.linalg.slogdet(w)[1] * nonpadding[..., 0].sum(-1)
        return torch.matmul(x, w) * nonpadding, logdet


class _AffineCoupling(nn.Module):
    def __init__(self, channels: int, hidden_size: int, kernel_size: int, n_layers: int,
                 c_cond: int = 0, sigmoid_scale: bool = False):
        super().__init__()
        half = channels // 2
        self.sigmoid_scale = sigmoid_scale
        self.pre = nn.Linear(half, hidden_size)
        self.enc = WN(hidden_size, kernel_size, 1, n_layers, c_cond)
        self.post = nn.Linear(hidden_size, 2 * half)
        zero_post(self)

    def forward(self, x, nonpadding, cond=None, reverse: bool = False):
        half = x.shape[-1] // 2
        x0, x1 = x[..., :half], x[..., half:]
        out = self.post(self.enc(self.pre(x0) * nonpadding, nonpadding, cond))
        m, logs = out[..., :half], out[..., half:]
        if self.sigmoid_scale:
            logs = torch.log(1e-6 + torch.sigmoid(logs + 2))
        if reverse:
            return torch.cat([x0, (x1 - m) * torch.exp(-logs) * nonpadding], -1), None
        x1 = (m + torch.exp(logs) * x1) * nonpadding
        return torch.cat([x0, x1], -1), (logs * nonpadding).sum((1, 2))


@torch.no_grad()
def zero_post(coupling: _AffineCoupling) -> None:
    """The coupling's output layer zero (flax's ``kernel_init`` of it and
    its zero bias): the block starts as the identity."""
    nn.init.zeros_(coupling.post.weight)
    nn.init.zeros_(coupling.post.bias)


class Glow(nn.Module):
    """``n_blocks`` blocks of [ActNorm, 1x1 product, affine coupling], the
    channels flipped after each. ``forward`` -> (z, log-determinant [B]);
    with ``reverse`` (x, None). ``cond`` [B, T, c_cond] at the frame rate."""

    def __init__(self, channels: int, hidden_size: int, kernel_size: int, n_blocks: int,
                 n_layers: int = 4, c_cond: int = 0, sigmoid_scale: bool = False):
        super().__init__()
        self.actnorms = nn.ModuleList(_ActNorm(channels) for _ in range(n_blocks))
        self.invconvs = nn.ModuleList(_InvConv(channels) for _ in range(n_blocks))
        self.couplings = nn.ModuleList(
            _AffineCoupling(channels, hidden_size, kernel_size, n_layers, c_cond, sigmoid_scale)
            for _ in range(n_blocks))

    def forward(self, x, nonpadding, cond=None, reverse: bool = False):
        blocks = list(zip(self.actnorms, self.invconvs, self.couplings))
        if reverse:
            for an, ic, cp in reversed(blocks):
                x, _ = cp(torch.flip(x, [-1]), nonpadding, cond, reverse=True)
                x, _ = ic(x, nonpadding, reverse=True)
                x, _ = an(x, nonpadding, reverse=True)
            return x, None
        logdet = x.new_zeros(x.shape[0])
        for an, ic, cp in blocks:
            x, ld1 = an(x, nonpadding)
            x, ld2 = ic(x, nonpadding)
            x, ld3 = cp(x, nonpadding, cond)
            logdet = logdet + ld1 + ld2 + ld3
            x = torch.flip(x, [-1])
        return x, logdet
