"""HiFi-GAN: the generator, mel ``[B, T, 80]`` -> wav ``[B, T *
prod(upsample_rates)]``; the multi-period and multi-scale discriminators;
the LSGAN and feature-matching losses.

Plain ``F.conv1d`` / ``F.conv2d`` / ``F.conv_transpose1d`` (the JAX package
leaves these convolutions to XLA; here they are cuDNN's). Parameter names
and the transposed-conv geometry (``padding=(k-u)//2``) follow the
reference torch modules, without weight or spectral normalisation (the
JAX package's discriminators are plain convs at every scale). A period
discriminator folds the wav into ``[B, 1, N/p, p]`` and runs ``(k, 1)``
kernels over it, the layout of flax's ``[B, N/p, p, 1]``; feature maps
keep torch's channel-first layout.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from speech_editing_tpu_torch.parallel.mesh import global_mean

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


class DiscriminatorP(nn.Module):
    """Period discriminator: the wav reflect-padded to a multiple of
    ``period``, folded to ``[B, 1, N/p, p]``; four (k, 1) convs of stride 3
    (32/128/512/1024 channels), a fifth of stride 1, a 3x1 post conv, each
    but the last followed by a 0.1 leaky ReLU."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3):
        super().__init__()
        self.period = period
        pad = (kernel_size - 1) // 2
        chans = (1, 32, 128, 512, 1024)
        self.convs = nn.ModuleList(
            nn.Conv2d(cin, cout, (kernel_size, 1), (stride, 1), padding=(pad, 0))
            for cin, cout in zip(chans, chans[1:]))
        self.convs.append(nn.Conv2d(1024, 1024, (kernel_size, 1), padding=(2, 0)))
        self.conv_post = nn.Conv2d(1024, 1, (3, 1), padding=(1, 0))

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, list]:
        """x [B, N] -> (scores [B, n], feature maps)."""
        b, t = x.shape
        if t % self.period:
            x = F.pad(x[:, None], (0, self.period - t % self.period), mode="reflect")[:, 0]
        x = x.reshape(b, 1, -1, self.period)
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.reshape(b, -1), fmap


# (channels, kernel, stride, groups, padding) of DiscriminatorS's convs
_SCALE_CONVS = ((128, 15, 1, 1, 7), (128, 41, 2, 4, 20), (256, 41, 2, 16, 20),
                (512, 41, 4, 16, 20), (1024, 41, 4, 16, 20), (1024, 41, 1, 16, 20),
                (1024, 5, 1, 1, 2))


class DiscriminatorS(nn.Module):
    """Scale discriminator: strided grouped 1-D convs (``_SCALE_CONVS``),
    each followed by a 0.1 leaky ReLU, then a 3-wide post conv."""

    def __init__(self):
        super().__init__()
        cins = (1,) + tuple(c for c, *_ in _SCALE_CONVS)
        self.convs = nn.ModuleList(
            nn.Conv1d(cin, c, k, s, padding=p, groups=g)
            for cin, (c, k, s, g, p) in zip(cins, _SCALE_CONVS))
        self.conv_post = nn.Conv1d(1024, 1, 3, padding=1)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, list]:
        """x [B, N] -> (scores [B, n], feature maps)."""
        x = x[:, None]
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.flatten(1), fmap


def _discriminate(discs, y, y_hat, pool=None):
    outs_r, outs_g, fmaps_r, fmaps_g = [], [], [], []
    for i, d in enumerate(discs):
        if pool is not None and i:
            y, y_hat = pool(y), pool(y_hat)
        o_r, f_r = d(y)
        o_g, f_g = d(y_hat)
        outs_r.append(o_r)
        outs_g.append(o_g)
        fmaps_r.append(f_r)
        fmaps_g.append(f_g)
    return outs_r, outs_g, fmaps_r, fmaps_g


class MultiPeriodDiscriminator(nn.Module):
    """One :class:`DiscriminatorP` a period. ``forward(y, y_hat)`` ->
    (real scores, fake scores, real feature maps, fake feature maps)."""

    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11)):
        super().__init__()
        self.discriminators = nn.ModuleList(DiscriminatorP(p) for p in periods)

    def forward(self, y, y_hat):
        return _discriminate(self.discriminators, y, y_hat)


def avg_pool_1d(x: torch.Tensor) -> torch.Tensor:
    """``AvgPool1d(4, 2, padding=1)`` over [B, N], the pads counted."""
    return F.avg_pool1d(x[:, None], 4, 2, padding=1, count_include_pad=True)[:, 0]


class MultiScaleDiscriminator(nn.Module):
    """``num_scales`` :class:`DiscriminatorS`, each after one more
    :func:`avg_pool_1d` of both wavs; outputs as the MPD's."""

    def __init__(self, num_scales: int = 3):
        super().__init__()
        self.discriminators = nn.ModuleList(DiscriminatorS() for _ in range(num_scales))

    def forward(self, y, y_hat):
        return _discriminate(self.discriminators, y, y_hat, avg_pool_1d)


def feature_loss(fmap_r, fmap_g) -> torch.Tensor:
    """2 x the sum of mean |real - fake| over every feature map, the real
    maps detached."""
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + global_mean(torch.abs(rl.detach() - gl))
    return loss * 2.0


def discriminator_loss(real_outputs, fake_outputs) -> tuple[torch.Tensor, torch.Tensor]:
    """LSGAN: (mean (1 - real)^2, mean fake^2), each averaged over the
    discriminators."""
    r, g = 0.0, 0.0
    for dr, dg in zip(real_outputs, fake_outputs):
        r = r + global_mean((1.0 - dr) ** 2)
        g = g + global_mean(dg ** 2)
    return r / len(real_outputs), g / len(real_outputs)


def generator_loss(fake_outputs) -> torch.Tensor:
    """LSGAN: mean (1 - fake)^2, averaged over the discriminators."""
    loss = 0.0
    for dg in fake_outputs:
        loss = loss + global_mean((1.0 - dg) ** 2)
    return loss / len(fake_outputs)
