"""Plain PyTorch reference of the HiFi-GAN V1 generator (Kong et al., 2020;
jik876/hifi-gan ``config_v1.json``) that vocodes both configurations: mel
[B, T, 80] -> wav [B, 256 T]. Parameter names are the published torch
generator's without weight normalisation. Imports no code of the program."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

SLOPE = 0.1


class ResBlock1(nn.Module):
    def __init__(self, ch, k, dilations):
        super().__init__()
        self.convs1 = nn.ModuleList(nn.Conv1d(ch, ch, k, dilation=d, padding=d * (k - 1) // 2)
                                    for d in dilations)
        self.convs2 = nn.ModuleList(nn.Conv1d(ch, ch, k, padding=(k - 1) // 2)
                                    for _ in dilations)

    def forward(self, x):
        for c1, c2 in zip(self.convs1, self.convs2):
            x = x + c2(F.leaky_relu(c1(F.leaky_relu(x, SLOPE)), SLOPE))
        return x


class Generator(nn.Module):
    def __init__(self, v):
        super().__init__()
        c0 = v["upsample_initial_channel"]
        self.n_res = len(v["resblock_kernel_sizes"])
        self.conv_pre = nn.Conv1d(80, c0, 7, padding=3)
        self.ups, self.resblocks = nn.ModuleList(), nn.ModuleList()
        for i, (u, k) in enumerate(zip(v["upsample_rates"], v["upsample_kernel_sizes"])):
            ch = c0 // 2 ** (i + 1)
            self.ups.append(nn.ConvTranspose1d(2 * ch, ch, k, stride=u, padding=(k - u) // 2))
            for rk, rd in zip(v["resblock_kernel_sizes"], v["resblock_dilation_sizes"]):
                self.resblocks.append(ResBlock1(ch, rk, rd))
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3)

    def forward(self, mel):
        x = self.conv_pre(mel.transpose(1, 2))
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, SLOPE))
            blocks = self.resblocks[i * self.n_res:(i + 1) * self.n_res]
            x = sum(b(x) for b in blocks) / self.n_res
        return torch.tanh(self.conv_post(F.leaky_relu(x, 0.01)))[:, 0]
