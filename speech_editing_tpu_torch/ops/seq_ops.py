"""Sequence and alignment ops on [B, T] id maps and [B, T, H] states."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def make_positions(tokens: torch.Tensor, padding_idx: int = 0) -> torch.Tensor:
    """Position ids starting at padding_idx+1, padding_idx at padding."""
    mask = (tokens != padding_idx).long()
    return torch.cumsum(mask, dim=1) * mask + padding_idx


def weights_nonzero_speech(target: torch.Tensor) -> torch.Tensor:
    """Weight 1 on frames whose mel row is not all-zero, broadcast to
    ``target``'s shape."""
    w = (target.abs().sum(-1, keepdim=True) != 0).to(target.dtype)
    return w.expand_as(target)


def length_regulator(dur: torch.Tensor, max_frames: int,
                     dur_padding: torch.Tensor | None = None,
                     alpha: float = 1.0) -> torch.Tensor:
    """Per-token durations [B, S] -> 1-based frame->token map [B, max_frames]
    (0 beyond the total length). Durations round half to even."""
    dur = torch.round(dur.float() * alpha).long()
    if dur_padding is not None:
        dur = dur * (~dur_padding).long()
    cum = torch.cumsum(dur, dim=1)                              # [B, S]
    pos = torch.arange(max_frames, device=dur.device)[None, :]  # [1, T]
    count = (cum[:, None, :] <= pos[:, :, None]).sum(-1)        # [B, T]
    return (count + 1) * (pos < cum[:, -1:]).long()


def expand_states(h: torch.Tensor, mel2token: torch.Tensor) -> torch.Tensor:
    """Token states to frame rate: [B, S, H], [B, T] -> [B, T, H].

    Id 0 maps to a zero row; ids past the last token clamp to it."""
    h = F.pad(h, (0, 0, 1, 0))
    ids = mel2token.long().clamp(0, h.shape[1] - 1)
    return torch.gather(h, 1, ids[:, :, None].expand(-1, -1, h.shape[2]))


def mel2token_to_dur(mel2token: torch.Tensor, T_txt: int) -> torch.Tensor:
    """Per-token durations [B, T_txt] from a 1-based frame->token map.
    Ids outside [0, T_txt] are dropped."""
    ids = mel2token.long()
    valid = (ids >= 0) & (ids <= T_txt)
    dur = torch.zeros(ids.shape[0], T_txt + 1, dtype=torch.long,
                      device=ids.device)
    dur.scatter_add_(1, ids.clamp(0, T_txt), valid.long())
    return dur[:, 1:]


def clip_mel2token_to_multiple(mel2token: torch.Tensor,
                               frames_multiple: int) -> torch.Tensor:
    max_frames = mel2token.shape[1] // frames_multiple * frames_multiple
    return mel2token[:, :max_frames]


def predictor_grad_scale(x: torch.Tensor, grad_scale: float) -> torch.Tensor:
    """Identity forward; scales the gradient flowing back into ``x`` by
    ``grad_scale`` (the predictors' ``predictor_grad``)."""
    if grad_scale == 1.0:
        return x
    return x.detach() + grad_scale * (x - x.detach())


def segment_sum(values: torch.Tensor, seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Per row, the sum of ``values`` [B, T, ...] over each id of
    ``seg_ids`` [B, T] in [0, num_segments): [B, num_segments, ...]
    (``jax.ops.segment_sum`` under ``vmap``)."""
    ids = seg_ids.long().reshape(seg_ids.shape + (1,) * (values.ndim - 2))
    out = values.new_zeros((values.shape[0], num_segments) + tuple(values.shape[2:]))
    return out.scatter_add(1, ids.expand_as(values), values)


def build_word_mask(x2word: torch.Tensor, y2word: torch.Tensor) -> torch.Tensor:
    """[B, X] and [B, Y] word ids -> [B, X, Y] int: 1 where the ids are
    equal (padding id 0 meets padding id 0 too)."""
    return (x2word[:, :, None] == y2word[:, None, :]).int()


def group_hidden_by_segs(h: torch.Tensor, seg_ids: torch.Tensor,
                         max_len: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean of the states [B, T, H] of each segment of ``seg_ids`` [B, T]
    (1-based, 0 padding): ([B, max_len, H], the counts [B, max_len]), a
    segment without states zero."""
    sums = segment_sum(h, seg_ids, max_len + 1)[:, 1:]
    cnts = segment_sum(torch.ones(seg_ids.shape, dtype=h.dtype, device=h.device), seg_ids,
                       max_len + 1)[:, 1:]
    return sums / cnts.clamp(min=1.0)[..., None], cnts
