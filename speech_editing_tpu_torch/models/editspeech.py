"""EditSpeech: a FastSpeech conditioner and two LSTM decoders, one scanning
forward and one backward, spliced where they agree best; the port of the
JAX package's ``models/editspeech.py``.

At inference (``forward``) the decoders read free-running inputs: the
frame states plus the prenet of the unmasked mel. In training
(``forward_train``) one coin for the whole batch, heads with p = 0.5
from a ``torch.Generator`` (or injected), swaps them for teacher-forced
inputs, ``proj_in`` of the ground-truth frames; the predictors drop out.

The backward decoder scans each row from its true end: the row is
right-aligned (rolled by T - len), flipped, scanned, flipped back and
rolled back, so a padded frame bucket feeds it the exact-fit sequence;
``ref_pad_compat`` flips the full padded axis instead, as the reference.
Parameter names are the reference torch module's (``fs.*``,
``decoder.{proj_in, prenet, forward_decoder, backward_decoder}``), as
``convert_editspeech`` reads them.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from speech_editing_tpu_torch.models.fs import FastSpeech
from speech_editing_tpu_torch.modules.lstm import LSTMDecoder
from speech_editing_tpu_torch.modules.predictors import MelEncoder
from speech_editing_tpu_torch.modules.transformer import sinusoidal_positional_embedding


TEACHER_FORCING_RATIO = 0.5   # the JAX model's teacher_forcing_ratio


class _Decoders(nn.Module):
    """The reference's ``decoder``: the teacher-forcing projection (a
    training input, unused at inference), the prenet and the two LSTMs."""

    def __init__(self, h: int, lstm_hidden: int, out_dims: int):
        super().__init__()
        self.proj_in = nn.Linear(out_dims, h)
        self.prenet = MelEncoder(out_dims, h)
        self.forward_decoder = LSTMDecoder(h, lstm_hidden, out_dims)
        self.backward_decoder = LSTMDecoder(h, lstm_hidden, out_dims)


def _gather_frames(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, T, C] at frames idx [B, T]."""
    return torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))


class EditSpeech(nn.Module):
    def __init__(self, vocab_size: int, hp: Any, out_dims: int = 80):
        super().__init__()
        self.hp = hp
        self.fs = FastSpeech(vocab_size, hp)
        self.decoder = _Decoders(hp["hidden_size"], int(hp.get("lstm_hidden", 1024)), out_dims)

    def _free_running(self, txt_tokens, time_mel_masks, mel2ph, spk_embed, ref_mels, f0, uv,
                      train=False, generator=None):
        ret = self.fs(txt_tokens, None, mel2ph, spk_embed, f0, uv, train=train,
                      generator=generator)
        decoder_inp = ret["decoder_inp"]
        pos_tokens = (ref_mels[..., 0] != 0).long()
        decoder_inp = decoder_inp + sinusoidal_positional_embedding(
            pos_tokens, decoder_inp.shape[-1]).to(decoder_inp.dtype)
        inputs = decoder_inp + self.decoder.prenet(ref_mels * (1 - time_mel_masks))
        return ret, inputs, pos_tokens

    def _decode(self, ret: dict, inputs, pos_tokens) -> dict:
        ret["forward_outputs"] = self.decoder.forward_decoder(inputs)
        backward = self.decoder.backward_decoder
        if self.hp.get("ref_pad_compat"):
            ret["backward_outputs"] = backward(inputs.flip(1)).flip(1)
            return ret
        t = inputs.shape[1]
        shift = (t - pos_tokens.sum(1))[:, None]
        pos = torch.arange(t, device=inputs.device)[None, :]
        right_aligned = _gather_frames(inputs, (pos - shift) % t)
        bwd = backward(right_aligned.flip(1)).flip(1)
        ret["backward_outputs"] = _gather_frames(bwd, (pos + shift) % t)
        return ret

    def forward(self, txt_tokens, time_mel_masks, mel2ph, spk_embed, ref_mels, f0, uv) -> dict:
        """txt_tokens [B, S]; time_mel_masks [B, T, 1]; mel2ph [B, T];
        spk_embed [B, 256] or None; ref_mels [B, T, 80]; f0, uv [B, T] ->
        the conditioner's dict with ``forward_outputs`` and
        ``backward_outputs`` [B, T, 80] (``dur`` [B, S] among the rest)."""
        ret, inputs, pos_tokens = self._free_running(txt_tokens, time_mel_masks, mel2ph,
                                                     spk_embed, ref_mels, f0, uv)
        return self._decode(ret, inputs, pos_tokens)

    def forward_train(self, txt_tokens, time_mel_masks, mel2ph, spk_embed, ref_mels, f0, uv,
                      train: bool = True, generator: torch.Generator | None = None,
                      teacher_forcing=None) -> dict:
        """As :meth:`forward` with the training inputs: ``teacher_forcing``
        (1 teacher-forced, 0 free-running; a 0-d tensor or a number) is drawn
        from ``generator`` when None; ``train`` turns predictor dropout on."""
        ret, inputs, pos_tokens = self._free_running(txt_tokens, time_mel_masks, mel2ph,
                                                     spk_embed, ref_mels, f0, uv, train,
                                                     generator)
        if teacher_forcing is None:
            teacher_forcing = (torch.rand((), device=inputs.device, generator=generator)
                               < TEACHER_FORCING_RATIO)
        tf = torch.as_tensor(teacher_forcing, device=inputs.device).to(inputs.dtype)
        inputs = tf * self.decoder.proj_in(ref_mels) + (1 - tf) * inputs
        return self._decode(ret, inputs, pos_tokens)


def fusion_index(forward_outputs, backward_outputs, time_mel_masks) -> torch.Tensor:
    """Each row's splice frame [B]: inside the mask, the first frame where
    the two directions' mean squared difference is least."""
    tm = time_mel_masks[..., 0]
    dist = ((forward_outputs - backward_outputs) ** 2).mean(-1) + (1 - tm) * 1e9
    return dist.argmin(-1)


def bidirectional_fusion(forward_outputs, backward_outputs, ref_mels,
                         time_mel_masks) -> torch.Tensor:
    """The forward decoder's frames before each row's splice frame
    (``fusion_index``), the backward decoder's from it on, inside the mask;
    ``ref_mels`` outside it."""
    t_fusion = fusion_index(forward_outputs, backward_outputs, time_mel_masks)
    t_idx = torch.arange(time_mel_masks.shape[1], device=ref_mels.device)[None, :]
    fwd_mask = (t_idx < t_fusion[:, None]).to(forward_outputs.dtype)[:, :, None]
    fused = forward_outputs * fwd_mask + backward_outputs * (1 - fwd_mask)
    return fused * time_mel_masks + ref_mels * (1 - time_mel_masks)
