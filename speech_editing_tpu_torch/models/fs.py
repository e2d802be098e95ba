"""FastSpeech as FluentSpeech's masked conditioner (``skip_decoder`` mode).

The duration predictor sees an embedding of the masked ground-truth
durations and the pitch predictor an embedding of the masked ground-truth
coarse pitch, so unedited regions anchor the predictions and only the
masked span is inpainted. The ``fft`` and ``conv`` text encoders are
ported; the decoder is never run by the editing path. In training
(``train=True``) the predictors run dropout with masks from an explicit
``torch.Generator``, and ``predictor_grad`` scales the gradient that
reaches the encoder through their inputs.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from speech_editing_tpu_torch.modules.conv import TextConvEncoder
from speech_editing_tpu_torch.modules.predictors import (DurationPredictor,
                                                         PitchPredictor)
from speech_editing_tpu_torch.modules.transformer import (FastSpeechEncoder,
                                                          TokenEmbedding)
from speech_editing_tpu_torch.ops.seq_ops import (clip_mel2token_to_multiple,
                                                  expand_states,
                                                  length_regulator,
                                                  mel2token_to_dur,
                                                  predictor_grad_scale)
from speech_editing_tpu_torch.utils.audio.pitch import denorm_f0, f0_to_coarse


class StyleEmbedMixin:
    """Speaker-style projection shared by the conditioners."""

    def forward_style_embed(self, spk_embed=None, spk_id=None):
        style = 0.0
        if self.hp.get("use_spk_embed") and spk_embed is not None:
            style = style + self.spk_embed_proj(spk_embed)[:, None, :]
        if self.hp.get("use_spk_id") and spk_id is not None:
            style = style + self.spk_id_proj(spk_id)[:, None, :]
        return style


class FastSpeech(StyleEmbedMixin, nn.Module):
    def __init__(self, vocab_size: int, hp: Any):
        super().__init__()
        self.hp = hp
        h = hp["hidden_size"]
        enc_type = hp.get("encoder_type", "fft")
        if enc_type == "fft":
            self.encoder = FastSpeechEncoder(vocab_size, h, hp["enc_layers"],
                                             hp["enc_ffn_kernel_size"], hp["num_heads"])
        elif enc_type == "conv":
            self.encoder = TextConvEncoder(
                vocab_size, h, h, tuple(hp["enc_dilations"]), hp["enc_kernel_size"],
                norm_type=hp.get("enc_dec_norm", "ln"),
                layers_in_block=hp.get("layers_in_block", 2),
                post_net_kernel=hp.get("enc_post_net_kernel", 3))
        else:
            raise NotImplementedError(f"encoder_type={enc_type}")
        if hp.get("use_spk_id"):
            self.spk_id_proj = TokenEmbedding(hp["num_spk"], h, padding_idx=-1)
        if hp.get("use_spk_embed"):
            self.spk_embed_proj = nn.Linear(256, h)
        pred_h = hp.get("predictor_hidden", -1)
        pred_h = pred_h if pred_h > 0 else h
        self.dur_embed = TokenEmbedding(2000, h)
        self.dur_predictor = DurationPredictor(h, pred_h, hp["dur_predictor_layers"],
                                               hp["dur_predictor_kernel"],
                                               hp["predictor_dropout"])
        if hp.get("use_pitch_embed"):
            self.pitch_embed = TokenEmbedding(300, h)
            self.pitch_predictor = PitchPredictor(h, pred_h, 5, 2,
                                                  hp["predictor_kernel"], 0.2)

    def forward_dur(self, dur_inp, time_mel_masks, mel2ph, txt_tokens, ret,
                    masked_dur=None, use_pred_mel2ph=False, train=False,
                    generator=None):
        if time_mel_masks is not None:
            if masked_dur is None:
                masked = (mel2ph * (1 - time_mel_masks[..., 0])).long()
                masked_dur = (mel2token_to_dur(masked, txt_tokens.shape[1])
                              * (txt_tokens != 0))
            dur_inp = dur_inp + self.dur_embed(masked_dur.long())
        src_padding = txt_tokens == 0
        dur_inp = predictor_grad_scale(dur_inp, self.hp.get("predictor_grad", 1.0))
        dur = self.dur_predictor(dur_inp, src_padding, train, generator)
        ret["dur"] = dur
        if use_pred_mel2ph:
            mel2ph = length_regulator(dur, mel2ph.shape[1], src_padding)
        mel2ph = clip_mel2token_to_multiple(mel2ph, self.hp.get("frames_multiple", 1))
        ret["mel2ph"] = mel2ph
        return mel2ph

    def forward_pitch(self, decoder_inp, time_mel_masks, f0, uv, mel2ph, ret,
                      use_pred_pitch=False, train=False, generator=None):
        hp = self.hp
        pitch_padding = mel2ph == 0
        use_uv = hp.get("pitch_type", "frame") == "frame" and hp.get("use_uv", True)
        pitch_inp = decoder_inp
        if time_mel_masks is not None:
            keep = 1 - time_mel_masks[..., 0]
            masked_gt_f0 = denorm_f0(f0 * keep, uv * keep if use_uv else None,
                                     pitch_padding=pitch_padding)
            pitch_inp = pitch_inp + self.pitch_embed(f0_to_coarse(masked_gt_f0))
        pitch_inp = predictor_grad_scale(pitch_inp, hp.get("predictor_grad", 1.0))
        # ref_pad_compat: the reference's predictor, not re-masked after each layer
        pp_mask = None if hp.get("ref_pad_compat") else pitch_padding
        pitch_pred = self.pitch_predictor(pitch_inp, pp_mask, train, generator)
        ret["pitch_pred"] = pitch_pred
        if use_pred_pitch:
            tm = time_mel_masks[..., 0] if time_mel_masks is not None else 1.0
            pred_uv = (pitch_pred[:, :, 1] > 0).to(uv.dtype)
            res_f0 = f0 * (1 - tm) + pitch_pred[:, :, 0] * tm
            res_uv = uv * (1 - tm) + pred_uv * tm if use_uv else uv
            padding_eff = None
        else:
            res_f0, res_uv, padding_eff = f0, uv, pitch_padding
        f0_denorm = denorm_f0(res_f0, res_uv if use_uv else None,
                              pitch_padding=padding_eff)
        ret["f0_denorm"] = f0_denorm
        ret["f0_denorm_pred"] = denorm_f0(
            pitch_pred[:, :, 0],
            (pitch_pred[:, :, 1] > 0).to(pitch_pred.dtype) if use_uv else None,
            pitch_padding=padding_eff)
        return self.pitch_embed(f0_to_coarse(f0_denorm))

    def forward(self, txt_tokens, time_mel_masks, mel2ph, spk_embed=None,
                f0=None, uv=None, spk_id=None, use_pred_mel2ph=False,
                use_pred_pitch=False, train=False, generator=None):
        """txt_tokens [B,S]; time_mel_masks [B,T,1]; mel2ph [B,T]; f0/uv [B,T]
        -> dict with ``decoder_inp`` [B,T,H], ``mel2ph``, ``dur``, pitch.
        ``train``: predictor dropout on, masks from ``generator``."""
        ret: dict = {}
        encoder_out = self.encoder(txt_tokens)
        src_nonpadding = (txt_tokens > 0)[:, :, None].to(encoder_out.dtype)
        style_embed = self.forward_style_embed(spk_embed, spk_id)
        dur_inp = (encoder_out + style_embed) * src_nonpadding
        mel2ph = self.forward_dur(dur_inp, time_mel_masks, mel2ph, txt_tokens, ret,
                                  use_pred_mel2ph=use_pred_mel2ph, train=train,
                                  generator=generator)
        tgt_nonpadding = (mel2ph > 0)[:, :, None].to(encoder_out.dtype)
        decoder_inp = expand_states(encoder_out, mel2ph)
        if self.hp.get("use_pitch_embed"):
            if f0 is None:
                f0 = torch.zeros(mel2ph.shape, device=mel2ph.device)
            if uv is None:
                uv = torch.zeros(mel2ph.shape, device=mel2ph.device)
            pitch_inp = (decoder_inp + style_embed) * tgt_nonpadding
            decoder_inp = decoder_inp + self.forward_pitch(
                pitch_inp, time_mel_masks, f0, uv, mel2ph, ret,
                use_pred_pitch=use_pred_pitch, train=train, generator=generator)
        ret["decoder_inp"] = (decoder_inp + style_embed) * tgt_nonpadding
        return ret
