"""HiFi-GAN generator: mel ``[B, T, 80]`` -> wav ``[B, T * prod(upsample_rates)]``.

Plain ``F.conv1d`` / ``F.conv_transpose1d`` (the JAX package leaves these
convolutions to XLA). Parameter names and the transposed-conv geometry
(``padding=(k-u)//2``) follow the reference torch generator, without weight
normalisation (its weights fold into plain convs at inference).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

LRELU_SLOPE = 0.1


def _same(k: int, d: int = 1) -> int:
    return d * (k - 1) // 2


class ResBlock1(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 3, dilations=(1, 3, 5)):
        super().__init__()
        self.convs1 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, dilation=d,
                      padding=_same(kernel_size, d)) for d in dilations)
        self.convs2 = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, padding=_same(kernel_size))
            for _ in dilations)

    def forward(self, x):
        for c1, c2 in zip(self.convs1, self.convs2):
            xt = c2(F.leaky_relu(c1(F.leaky_relu(x, LRELU_SLOPE)), LRELU_SLOPE))
            x = x + xt
        return x


class ResBlock2(nn.Module):
    def __init__(self, channels: int, kernel_size: int = 3, dilations=(1, 3)):
        super().__init__()
        self.convs = nn.ModuleList(
            nn.Conv1d(channels, channels, kernel_size, dilation=d,
                      padding=_same(kernel_size, d)) for d in dilations)

    def forward(self, x):
        for c in self.convs:
            x = x + c(F.leaky_relu(x, LRELU_SLOPE))
        return x


class HifiGanGenerator(nn.Module):
    """hp keys: ``upsample_rates``, ``upsample_kernel_sizes``,
    ``upsample_initial_channel``, ``resblock``, ``resblock_kernel_sizes``,
    ``resblock_dilation_sizes``; ``num_mels`` defaults to 80."""

    def __init__(self, hp: Any):
        super().__init__()
        c0 = hp["upsample_initial_channel"]
        res_cls = ResBlock1 if str(hp.get("resblock", "1")) == "1" else ResBlock2
        self.n_res = len(hp["resblock_kernel_sizes"])
        self.conv_pre = nn.Conv1d(hp.get("num_mels", 80), c0, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(hp["upsample_rates"], hp["upsample_kernel_sizes"])):
            if (k - u) % 2:
                raise ValueError(f"upsample kernel {k} - rate {u} must be even")
            ch = c0 // (2 ** (i + 1))
            self.ups.append(nn.ConvTranspose1d(2 * ch, ch, k, stride=u,
                                               padding=(k - u) // 2))
            for rk, rd in zip(hp["resblock_kernel_sizes"], hp["resblock_dilation_sizes"]):
                self.resblocks.append(res_cls(ch, rk, tuple(rd)))
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = self.conv_pre(mel.transpose(1, 2))
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            blocks = self.resblocks[i * self.n_res:(i + 1) * self.n_res]
            x = sum(blk(x) for blk in blocks) / self.n_res
        # the final activation uses torch's default slope 0.01
        x = self.conv_post(F.leaky_relu(x, 0.01))
        return torch.tanh(x)[:, 0]
