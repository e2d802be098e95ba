"""Duration, pitch and energy predictors and the masked-mel encoder.
Parameter names follow the reference torch modules (``conv.{i}.0`` conv,
``conv.{i}.2`` LayerNorm, ``linear``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from speech_editing_tpu_torch.parallel.mesh import draw_rows
from speech_editing_tpu_torch.utils.dtypes import Softplus


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator | None = None) -> torch.Tensor:
    """Inverted dropout whose keep mask comes from ``generator`` (flax
    ``nn.Dropout``: keep with probability 1 - rate, scale by its inverse),
    drawn for the global batch under data parallelism."""
    keep = 1.0 - rate
    mask = draw_rows(x.shape[0], lambda n: torch.bernoulli(
        torch.full((n,) + tuple(x.shape[1:]), keep, dtype=x.dtype, device=x.device),
        generator=generator))
    return x * mask / keep


class _ConvStack(nn.Module):
    """conv (SAME) -> ReLU -> LayerNorm -> dropout (training only),
    re-masked after each layer, then a linear head."""

    def __init__(self, idim: int, n_chans: int, n_layers: int, kernel_size: int,
                 head: nn.Module, dropout_rate: float = 0.0):
        super().__init__()
        self.kernel_size = kernel_size
        self.dropout_rate = dropout_rate
        self.conv = nn.ModuleList(
            nn.Sequential(nn.Conv1d(idim if i == 0 else n_chans, n_chans, kernel_size),
                          nn.ReLU(), nn.LayerNorm(n_chans, eps=1e-5))
            for i in range(n_layers))
        self.linear = head

    def forward(self, x: torch.Tensor, x_padding: torch.Tensor | None = None,
                train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``train`` turns dropout on, its masks drawn from ``generator``."""
        k = self.kernel_size
        keep = None if x_padding is None else (~x_padding)[:, :, None].to(x.dtype)
        for conv, _, ln in self.conv:
            y = F.pad(x.transpose(1, 2), ((k - 1) // 2, k // 2))
            x = ln(torch.relu(conv(y)).transpose(1, 2))
            if train and self.dropout_rate > 0:
                x = dropout(x, self.dropout_rate, generator)
            if keep is not None:
                x = x * keep
        x = self.linear(x)
        return x if keep is None else x * keep


class DurationPredictor(_ConvStack):
    """[B, S, H] -> durations [B, S] (Softplus head)."""

    def __init__(self, idim: int, n_chans: int = 384, n_layers: int = 2,
                 kernel_size: int = 3, dropout_rate: float = 0.1):
        super().__init__(idim, n_chans, n_layers, kernel_size,
                         nn.Sequential(nn.Linear(n_chans, 1), Softplus()),
                         dropout_rate)

    def forward(self, x, x_padding=None, train=False, generator=None):
        return super().forward(x, x_padding, train, generator)[..., 0]


class PitchPredictor(_ConvStack):
    """[B, T, H] -> [B, T, odim] (f0, uv logit)."""

    def __init__(self, idim: int, n_chans: int = 384, n_layers: int = 5,
                 odim: int = 2, kernel_size: int = 5, dropout_rate: float = 0.1):
        super().__init__(idim, n_chans, n_layers, kernel_size,
                         nn.Linear(n_chans, odim), dropout_rate)


class EnergyPredictor(PitchPredictor):
    """[B, T, H] -> [B, T, odim]; FastSpeech2-orig reads channel 0."""


class MelEncoder(nn.Module):
    """3-layer MLP mel -> hidden (``encoder.0``, ``encoder.2``, ``fc_out``)."""

    def __init__(self, input_dim: int = 80, hidden_size: int = 192):
        super().__init__()
        self.encoder = nn.Sequential(nn.Linear(input_dim, hidden_size), nn.ReLU(),
                                     nn.Linear(hidden_size, hidden_size), nn.ReLU())
        self.fc_out = nn.Linear(hidden_size, hidden_size)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        return self.fc_out(self.encoder(mel))
