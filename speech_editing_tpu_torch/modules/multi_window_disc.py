"""The multi-window mel discriminator of adversarial PortaSpeech; the port
of the JAX package's ``modules/multi_window_disc.py``.

Each window length (32, 64, 128 frames) has a :class:`SingleWindowDisc`:
three 3x3 stride-2 2-D convolutions over (frames, mel bins) with flax's
``SAME`` padding (on an even size one frame or bin after, none before),
each followed by a leaky ReLU and, for the first two, a LayerNorm over the
channels (flax's eps 1e-6), then a linear validity over the channel-last
flattening [T', F', C]. The JAX package never runs its dropout (it never
passes ``train`` to the discriminator), so the port has none.

:class:`MultiWindowDiscriminator` clips a window of each length from every
row at a start drawn in [0, max(x_len - win, 1)) (or given as
``start_frames``, to score the generator step's windows again) and sums the
validities; a row shorter than a window contributes nothing for it, neither
validity nor hiddens. The convolutions are cuDNN's: no kernel of the
port's runs here.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from speech_editing_tpu_torch.parallel.mesh import draw_rows


def _pad_same(x: torch.Tensor, kernel: Sequence[int], stride: int) -> torch.Tensor:
    """flax's ``SAME`` padding of [B, C, H, W] for a ``kernel`` at
    ``stride``: the total split low half first."""
    pads = []
    for size, k in zip(reversed(x.shape[2:]), reversed(kernel)):
        total = max((-(-size // stride) - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class SingleWindowDisc(nn.Module):
    def __init__(self, time_length: int, freq_length: int = 80,
                 kernel: Sequence[int] = (3, 3), hidden_size: int = 128):
        super().__init__()
        self.kernel = tuple(kernel)
        self.convs = nn.ModuleList(nn.Conv2d(1 if i == 0 else hidden_size, hidden_size,
                                             self.kernel, stride=2) for i in range(3))
        self.norms = nn.ModuleList(nn.LayerNorm(hidden_size, eps=1e-6) for _ in range(2))
        t, f = time_length, freq_length
        for _ in range(3):
            t, f = -(-t // 2), -(-f // 2)
        self.adv_layer = nn.Linear(t * f * hidden_size, 1)

    def forward(self, x: torch.Tensor):
        """x [B, T_win, n_bins] -> (validity [B, 1], hiddens, each
        [B, T', F', C])."""
        h = []
        x = x[:, None]
        for i, conv in enumerate(self.convs):
            x = F.leaky_relu(conv(_pad_same(x, self.kernel, 2)), 0.2)
            y = x.permute(0, 2, 3, 1)
            if i < 2:
                y = self.norms[i](y)
                x = y.permute(0, 3, 1, 2)
            h.append(y)
        return self.adv_layer(h[-1].reshape(h[-1].shape[0], -1)), h


class MultiWindowDiscriminator(nn.Module):
    def __init__(self, time_lengths: Sequence[int] = (32, 64, 128), freq_length: int = 80,
                 kernel: Sequence[int] = (3, 3), hidden_size: int = 128):
        super().__init__()
        self.time_lengths = tuple(time_lengths)
        self.discs = nn.ModuleList(SingleWindowDisc(w, freq_length, kernel, hidden_size)
                                   for w in self.time_lengths)

    def forward(self, x: torch.Tensor, x_len: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                start_frames: Optional[Sequence[torch.Tensor]] = None) -> dict:
        """x [B, T, n_bins]; x_len [B]. -> {"y" [B, 1], "h", "start_frames"}:
        the starts are drawn from ``generator`` for the global batch unless
        given."""
        b, t, _ = x.shape
        validity = x.new_zeros(b, 1)
        hiddens, starts = [], []
        for i, (win, disc) in enumerate(zip(self.time_lengths, self.discs)):
            if start_frames is None:
                draw = draw_rows(b, lambda n: torch.randint(0, 2 ** 30, (n,), generator=generator,
                                                            device=x.device))
                start = draw % (x_len - win).clamp(min=1)
            else:
                start = start_frames[i]
            starts.append(start)
            idx = (start[:, None] + torch.arange(win, device=x.device)).clamp(0, t - 1)
            v, h = disc(torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2])))
            ok = (x_len >= win).to(v.dtype)[:, None]
            validity = validity + v * ok
            hiddens += [hh * ok[:, :, None, None] for hh in h]
        return {"y": validity, "h": hiddens, "start_frames": starts}
