"""DiffNet: the x0-predicting WaveNet denoiser of FluentSpeech; and WN,
the Glow-TTS gated conv stack of the stutter predictor's decoder.

DiffNet: spec ``[B, T, M]`` -> ``[B, T, M]``. Every gated residual block
runs through kernel K1 (``ops/cuda/diffnet_block.py``), and, when autograd
records, its backward through kernel K5; with ``remat`` (``remat_diffnet``)
a block keeps no pre-activation for the backward, which launches K1 again
to recompute it. On the card a block outside the
kernels' envelope (``diffnet_block_takes``: the widths compiled, float32 or
bf16) raises, and runs with ``--device cpu``. Parameter names follow the
reference torch DiffNet (``residual_layers.{i}.dilated_conv`` and so on).

WN is plain convolutions (no kernel of its own), named as the reference's
``modules/commons/wavenet.py`` (``in_layers.{i}``, ``res_skip_layers.{i}``,
``cond_layer``) with its weight norm folded.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from speech_editing_tpu_torch.modules.conv import conv_same
from speech_editing_tpu_torch.modules.predictors import dropout as drop
from speech_editing_tpu_torch.ops.cuda.diffnet_block import (diffnet_block,
                                                             diffnet_block_train)
from speech_editing_tpu_torch.utils.dtypes import Mish, weak


class WN(nn.Module):
    """[B, T, H] -> [B, T, H]: ``n_layers`` gated convs (tanh of the first
    half times sigmoid of the second, dilation ``dilation_rate ** i``, the
    input dropped out in training) plus each layer's slice of one 1x1
    ``cond_layer`` over ``cond`` [B, T, c_cond]; residual adds re-masked by
    ``nonpadding`` [B, T, 1] (default all frames) and a skip sum."""

    def __init__(self, hidden_size: int, kernel_size: int = 5, dilation_rate: int = 1,
                 n_layers: int = 4, c_cond: int = 0, dropout: float = 0.0):
        super().__init__()
        h = self.hidden_size = hidden_size
        self.dropout = dropout
        if c_cond:
            self.cond_layer = nn.Conv1d(c_cond, 2 * h * n_layers, 1)
        self.in_layers = nn.ModuleList(
            nn.Conv1d(h, 2 * h, kernel_size, dilation=dilation_rate ** i)
            for i in range(n_layers))
        self.res_skip_layers = nn.ModuleList(
            nn.Conv1d(h, 2 * h if i < n_layers - 1 else h, 1) for i in range(n_layers))

    def forward(self, x, nonpadding=None, cond=None, train: bool = False,
                generator: torch.Generator | None = None):
        """``train`` turns dropout on, its masks from ``generator``."""
        h = self.hidden_size
        if nonpadding is None:
            nonpadding = torch.ones_like(x[..., :1])
        if cond is not None:
            cond_all = conv_same(self.cond_layer, cond)
        output = torch.zeros_like(x)
        last = len(self.in_layers) - 1
        for i, (conv, res_skip) in enumerate(zip(self.in_layers, self.res_skip_layers)):
            x_in = conv_same(conv, x)
            if train and self.dropout > 0:
                x_in = drop(x_in, self.dropout, generator)
            if cond is not None:
                x_in = x_in + cond_all[..., i * 2 * h:(i + 1) * 2 * h]
            acts = torch.tanh(x_in[..., :h]) * torch.sigmoid(x_in[..., h:])
            rs = conv_same(res_skip, acts)
            if i < last:
                x = (x + rs[..., :h]) * nonpadding
                output = output + rs[..., h:]
            else:
                output = output + rs
        return output * nonpadding


def diffusion_step_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """[B] integer steps -> [B, dim] sinusoidal embedding [sin | cos]."""
    half = dim // 2
    freq = torch.exp(torch.arange(half, device=t.device)
                     * -(math.log(10000) / (half - 1)))
    ang = t.float()[:, None] * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class DiffNetResidualBlock(nn.Module):
    def __init__(self, encoder_hidden: int, residual_channels: int, dilation: int,
                 remat: bool = False):
        super().__init__()
        c = residual_channels
        self.dilation, self.remat = dilation, remat
        self.dilated_conv = nn.Conv1d(c, 2 * c, 3, padding=dilation, dilation=dilation)
        self.diffusion_projection = nn.Linear(c, c)
        self.conditioner_projection = nn.Conv1d(encoder_hidden, 2 * c, 1)
        self.output_projection = nn.Conv1d(c, 2 * c, 1)

    def kernel_weights(self) -> tuple[torch.Tensor, ...]:
        """(wd [3C, 2C], bd, wc [H, 2C], bc, wo [C, 2C], bo): the conv weights
        in the layout K1 takes (row tap*C + c_in of wd)."""
        c2 = self.dilated_conv.out_channels
        return (self.dilated_conv.weight.permute(2, 1, 0).reshape(-1, c2).contiguous(),
                self.dilated_conv.bias,
                self.conditioner_projection.weight[:, :, 0].t().contiguous(),
                self.conditioner_projection.bias,
                self.output_projection.weight[:, :, 0].t().contiguous(),
                self.output_projection.bias)

    def forward(self, x, cond, step_emb, nonpadding=None, weights=None):
        """x [B,T,C]; cond [B,T,H]; step_emb [B,C]; nonpadding [B,T] or None;
        ``weights`` from :meth:`kernel_weights` (computed here if None).
        With grad enabled the block is K1 + K5 (``diffnet_block_train``,
        which under ``remat`` launches K1 again in the backward); gradients
        reach the conv weights through ``kernel_weights``."""
        step = self.diffusion_projection(step_emb)
        w = self.kernel_weights() if weights is None else weights
        if not torch.is_grad_enabled():
            return diffnet_block(x, cond, step, nonpadding, *w, dilation=self.dilation)
        return diffnet_block_train(x, cond, step, nonpadding, *w, dilation=self.dilation,
                                   remat=self.remat)


class DiffNet(nn.Module):
    def __init__(self, in_dims: int = 80, encoder_hidden: int = 192,
                 residual_layers: int = 20, residual_channels: int = 256,
                 dilation_cycle_length: int = 1, remat: bool = False):
        super().__init__()
        c = residual_channels
        self.input_projection = nn.Conv1d(in_dims, c, 1)
        self.mlp = nn.Sequential(nn.Linear(c, 4 * c), Mish(), nn.Linear(4 * c, c))
        self.residual_layers = nn.ModuleList(
            DiffNetResidualBlock(encoder_hidden, c, 2 ** (i % dilation_cycle_length), remat)
            for i in range(residual_layers))
        self.skip_projection = nn.Conv1d(c, c, 1)
        self.output_projection = nn.Conv1d(c, in_dims, 1)

    def kernel_weights(self) -> list[tuple[torch.Tensor, ...]]:
        """Every block's K1 weights; compute once per sampling run or step."""
        return [layer.kernel_weights() for layer in self.residual_layers]

    def forward(self, spec, diffusion_step, cond, nonpadding=None, weights=None):
        """spec [B,T,M]; diffusion_step [B]; cond [B,T,H]; nonpadding [B,T]."""
        x = F.relu(F.linear(spec, self.input_projection.weight[:, :, 0],
                            self.input_projection.bias))
        c = x.shape[-1]
        # in the activations' dtype before the MLP, as JAX casts it: a
        # float32 embedding would meet bf16 weights
        step = self.mlp(diffusion_step_embedding(diffusion_step, c).to(x.dtype))
        weights = self.kernel_weights() if weights is None else weights
        skip_sum = torch.zeros_like(x)
        for layer, w in zip(self.residual_layers, weights):
            x, skip = layer(x, cond, step, nonpadding, w)
            skip_sum = skip_sum + skip
        x = skip_sum / weak(math.sqrt(len(self.residual_layers)), skip_sum)
        x = F.relu(F.linear(x, self.skip_projection.weight[:, :, 0],
                            self.skip_projection.bias))
        return F.linear(x, self.output_projection.weight[:, :, 0],
                        self.output_projection.bias)
