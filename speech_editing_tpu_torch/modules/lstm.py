"""Stacked LSTM decoder with a linear head, the port of the JAX package's
``modules/lstm.py`` (``LSTMDecoder``: flax ``OptimizedLSTMCell``s scanned
over time).

``torch.nn.LSTM`` carries the recurrence (cuDNN on the card). Its gates
map to flax's per-gate kernels as ``utils/convert_jax_params.py`` and the
JAX package's ``convert_lstm`` lay them out: ``weight_ih_l{n}`` stacks
``ii, if, ig, io`` ([4H, in], rows i, f, g, o), ``weight_hh_l{n}`` stacks
``hi, hf, hg, ho``, ``bias_hh_l{n}`` their biases, and ``bias_ih_l{n}``
is zero (flax's input kernels have none): it is frozen, so training moves
the one bias flax has, as the JAX step does.
"""

from __future__ import annotations

import torch
from torch import nn


class LSTMDecoder(nn.Module):
    """[B, T, input_size] -> [B, T, out_dim]: ``num_layers`` stacked LSTMs
    from a zero state, then ``linear``."""

    def __init__(self, input_size: int, hidden_size: int, out_dim: int, num_layers: int = 2):
        super().__init__()
        self.lstm = nn.LSTM(input_size, hidden_size, num_layers, batch_first=True)
        for n in range(num_layers):
            getattr(self.lstm, f"bias_ih_l{n}").requires_grad_(False)
        self.linear = nn.Linear(hidden_size, out_dim)

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        hs, _ = self.lstm(xs)
        return self.linear(hs)
