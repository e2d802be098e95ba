"""FastSpeech2 (original variant): FastSpeech with an energy embedding and,
under ``pitch_type: cwt``, a pitch predictor in the continuous-wavelet
domain.

The energy predictor's output (or the ground-truth frame energy in
training) is quantised to 256 bins and embedded. The CWT predictor gives
10 wavelet scales and a uv logit a frame, and three dense layers over the
time-averaged input give the utterance's log-f0 mean and std; without a
ground-truth f0 (inference) the f0 is rebuilt from them by ``cwt2f0``,
its std scaled by ``cwt_std_scale``. Durations are predicted whenever
``infer`` is set. Other pitch types take FastSpeech's frame-level pitch
path.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from speech_editing_tpu_torch.models.fs import FastSpeech
from speech_editing_tpu_torch.modules.predictors import EnergyPredictor, PitchPredictor
from speech_editing_tpu_torch.modules.transformer import TokenEmbedding
from speech_editing_tpu_torch.ops.seq_ops import expand_states, predictor_grad_scale
from speech_editing_tpu_torch.utils.audio.cwt import cwt2f0
from speech_editing_tpu_torch.utils.audio.pitch import denorm_f0, f0_to_coarse, norm_f0


class FastSpeech2Orig(FastSpeech):
    def __init__(self, vocab_size: int, hp: Any):
        super().__init__(vocab_size, hp, decoder=True, masked=False)
        h = hp["hidden_size"]
        pred_h = hp.get("predictor_hidden", -1)
        pred_h = pred_h if pred_h > 0 else h
        layers, kernel = hp.get("predictor_layers", 5), hp.get("predictor_kernel", 5)
        rate = hp.get("predictor_dropout", 0.2)
        self.cwt = hp.get("pitch_type") == "cwt" and bool(hp.get("use_pitch_embed"))
        if hp.get("use_energy_embed"):
            self.energy_embed = TokenEmbedding(300, h)
            self.energy_predictor = EnergyPredictor(h, pred_h, layers, 2, kernel, rate)
        if self.cwt:
            del self.pitch_predictor    # the frame-level one: never run, as in JAX
            self.cwt_pitch_predictor = PitchPredictor(h, pred_h, layers, 11, kernel, rate)
            self.cwt_stats_layers = nn.ModuleList(
                [nn.Linear(h, h), nn.Linear(h, h), nn.Linear(h, 2)])

    def forward(self, txt_tokens, mel2ph=None, spk_embed=None, f0=None, uv=None,
                energy=None, infer=False, train=False, generator=None, spk_id=None):
        """txt_tokens [B,S]; mel2ph [B,T] (durations predicted when
        ``infer``, regulated to its length or ``max_frames``); f0/uv [B,T]
        (None: predicted); energy [B,T] (None: predicted) -> dict with
        ``mel_out``, ``dur``, ``mel2ph``, the pitch outputs (``cwt``,
        ``f0_mean``, ``f0_std``, ``f0_denorm``) and ``energy_pred``."""
        hp = self.hp
        ret: dict = {}
        encoder_out = self.encode(txt_tokens, train, generator)
        src_nonpadding = (txt_tokens > 0)[:, :, None].to(encoder_out.dtype)
        style_embed = self.forward_style_embed(spk_embed, spk_id)
        mel2ph = self.forward_dur((encoder_out + style_embed) * src_nonpadding, None, mel2ph,
                                  txt_tokens, ret, use_pred_mel2ph=infer, train=train,
                                  generator=generator)
        tgt_nonpadding = (mel2ph > 0)[:, :, None].to(encoder_out.dtype)
        decoder_inp = decoder_inp_ = expand_states(encoder_out, mel2ph)
        if hp.get("use_pitch_embed"):
            pitch_inp = (decoder_inp_ + style_embed) * tgt_nonpadding
            if self.cwt:
                decoder_inp = decoder_inp + self.forward_cwt_pitch(
                    pitch_inp, f0, uv, mel2ph, ret, train, generator)
            else:
                zeros = torch.zeros(mel2ph.shape, device=mel2ph.device)
                decoder_inp = decoder_inp + self.forward_pitch(
                    pitch_inp, None, zeros if f0 is None else f0, zeros if uv is None else uv,
                    mel2ph, ret, use_pred_pitch=infer, train=train, generator=generator)
        if hp.get("use_energy_embed"):
            energy_inp = (decoder_inp_ + style_embed) * tgt_nonpadding
            decoder_inp = decoder_inp + self.forward_energy(energy_inp, energy, ret, train,
                                                            generator)
        ret["decoder_inp"] = decoder_inp = (decoder_inp + style_embed) * tgt_nonpadding
        ret["mel_out"] = self.decode(decoder_inp, tgt_nonpadding, train, generator)
        return ret

    def forward_cwt_pitch(self, decoder_inp, f0, uv, mel2ph, ret, train=False,
                          generator=None):
        hp = self.hp
        use_uv = hp.get("use_uv", True)
        decoder_inp = predictor_grad_scale(decoder_inp, hp.get("predictor_grad", 1.0))
        cwt_out = self.cwt_pitch_predictor(decoder_inp, None, train, generator)
        ret["cwt"] = cwt_out
        stats = decoder_inp.mean(1)
        for i, layer in enumerate(self.cwt_stats_layers):
            stats = layer(stats)
            if i < len(self.cwt_stats_layers) - 1:
                stats = torch.relu(stats)
        ret["f0_mean"] = mean = stats[:, 0]
        ret["f0_std"] = std = stats[:, 1]
        if f0 is None:      # inference: f0 rebuilt from the predicted coefficients
            std = std * hp.get("cwt_std_scale", 0.8)
            f0 = norm_f0(cwt2f0(cwt_out[:, :, :10], mean, std), None)
            if use_uv:
                uv = (cwt_out[:, :, -1] > 0).float()
        f0_denorm = denorm_f0(f0, uv if use_uv else None, pitch_padding=mel2ph == 0)
        ret["f0_denorm"] = f0_denorm
        return self.pitch_embed(f0_to_coarse(f0_denorm))

    def forward_energy(self, decoder_inp, energy, ret, train=False, generator=None):
        decoder_inp = predictor_grad_scale(decoder_inp, self.hp.get("predictor_grad", 1.0))
        energy_pred = self.energy_predictor(decoder_inp, None, train, generator)[:, :, 0]
        ret["energy_pred"] = energy_pred
        inp = energy_pred if energy is None else energy
        ids = torch.div(inp * 256, 4, rounding_mode="floor").long().clamp(0, 255)
        return self.energy_embed(ids)
