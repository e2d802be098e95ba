"""FastSpeech: the plain non-autoregressive TTS baseline, and FluentSpeech's
masked conditioner.

As the conditioner of the editing models (built without a decoder) the
duration predictor sees an embedding of the masked ground-truth durations
and the pitch predictor an embedding of the masked ground-truth coarse
pitch, so unedited regions anchor the predictions and only the masked span
is inpainted. Built with ``decoder=True`` (and ``masked=False``: no
duration embedding, as the JAX package's TTS tree has none) it is the TTS
model: the frame-rate states go through the ``decoder_type`` decoder
(``fft``, ``conv``, ``wn`` or ``rnn``) and ``mel_out`` to a mel. The text
encoder is ``encoder_type`` ``fft``, ``conv``, ``rel_fft``, ``tacotron``
or ``tacotron2``. In training (``train=True``) the predictors, and the
encoders and decoders that have dropout, draw their masks from an explicit
``torch.Generator``, and ``predictor_grad`` scales the gradient that
reaches the encoder through the predictors' inputs.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from speech_editing_tpu_torch.modules.conv import ConvBlocks, TextConvEncoder
from speech_editing_tpu_torch.modules.predictors import (DurationPredictor,
                                                         PitchPredictor)
from speech_editing_tpu_torch.modules.rel_transformer import RelTransformerEncoder
from speech_editing_tpu_torch.modules.rnn import DecoderRNN, RNNEncoder, TacotronEncoder
from speech_editing_tpu_torch.modules.transformer import (FastSpeechDecoder,
                                                          FastSpeechEncoder,
                                                          TokenEmbedding)
from speech_editing_tpu_torch.modules.wavenet import WN
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


# the encoders whose forward takes (train, generator): they have dropout
_DROPOUT_ENCODERS = (RelTransformerEncoder, TacotronEncoder, RNNEncoder)


def build_encoder(vocab_size: int, hp: Any) -> nn.Module:
    """The ``encoder_type`` text encoder at ``hidden_size``."""
    h = hp["hidden_size"]
    enc_type = hp.get("encoder_type", "fft")
    if enc_type == "fft":
        return FastSpeechEncoder(vocab_size, h, hp["enc_layers"], hp["enc_ffn_kernel_size"],
                                 hp["num_heads"], remat=bool(hp.get("remat_fft", False)))
    if enc_type == "conv":
        return TextConvEncoder(vocab_size, h, h, tuple(hp["enc_dilations"]),
                               hp["enc_kernel_size"], norm_type=hp.get("enc_dec_norm", "ln"),
                               layers_in_block=hp.get("layers_in_block", 2),
                               post_net_kernel=hp.get("enc_post_net_kernel", 3))
    if enc_type == "rel_fft":
        return RelTransformerEncoder(vocab_size, h, hp["enc_layers"],
                                     hp.get("enc_ffn_kernel_size", 3), hp["num_heads"],
                                     dropout=hp.get("dropout", 0.0),
                                     prenet=hp.get("enc_prenet", True))
    if enc_type == "tacotron":
        return TacotronEncoder(vocab_size, h)
    if enc_type == "tacotron2":
        return RNNEncoder(vocab_size, h)
    raise NotImplementedError(f"encoder_type={enc_type}")


def build_decoder(hp: Any) -> nn.Module:
    """The ``decoder_type`` mel decoder at ``hidden_size``."""
    h = hp["hidden_size"]
    dec_type = hp.get("decoder_type", "fft")
    if dec_type == "fft":
        return FastSpeechDecoder(h, hp["dec_layers"], hp["dec_ffn_kernel_size"], hp["num_heads"],
                                 remat=bool(hp.get("remat_fft", False)))
    if dec_type == "conv":
        return ConvBlocks(h, h, tuple(hp["dec_dilations"]), hp["dec_kernel_size"],
                          norm_type=hp.get("enc_dec_norm", "ln"),
                          layers_in_block=hp.get("layers_in_block", 2),
                          post_net_kernel=hp.get("dec_post_net_kernel", 3),
                          dropout=hp.get("dropout", 0.0))
    if dec_type == "wn":
        return WN(h, kernel_size=5, dilation_rate=1, n_layers=hp["dec_layers"])
    if dec_type == "rnn":
        return DecoderRNN(h)
    raise NotImplementedError(f"decoder_type={dec_type}")


class FastSpeech(StyleEmbedMixin, nn.Module):
    """``decoder``: build the mel decoder and ``mel_out`` (the TTS model);
    ``masked``: build the duration embedding that the masked conditioner
    reads."""

    def __init__(self, vocab_size: int, hp: Any, decoder: bool = False, masked: bool = True,
                 out_dims: int | None = None):
        super().__init__()
        self.hp = hp
        h = hp["hidden_size"]
        self.encoder = build_encoder(vocab_size, hp)
        self.decoder = build_decoder(hp) if decoder else None
        if decoder:
            self.mel_out = nn.Linear(h, out_dims or hp["audio_num_mel_bins"])
        if hp.get("use_spk_id"):
            self.spk_id_proj = TokenEmbedding(hp["num_spk"], h, padding_idx=-1)
        if hp.get("use_spk_embed"):
            self.spk_embed_proj = nn.Linear(256, h)
        pred_h = hp.get("predictor_hidden", -1)
        pred_h = pred_h if pred_h > 0 else h
        if masked:
            self.dur_embed = TokenEmbedding(2000, h)
        self.dur_predictor = DurationPredictor(h, pred_h, hp["dur_predictor_layers"],
                                               hp["dur_predictor_kernel"],
                                               hp["predictor_dropout"])
        if hp.get("use_pitch_embed"):
            self.pitch_embed = TokenEmbedding(300, h)
            self.pitch_predictor = PitchPredictor(h, pred_h, 5, 2,
                                                  hp["predictor_kernel"], 0.2)

    def encode(self, txt_tokens, train=False, generator=None):
        """The text encoder's states [B, S, H]; ``train`` turns on the
        dropout of the encoders that have it."""
        if isinstance(self.encoder, _DROPOUT_ENCODERS):
            return self.encoder(txt_tokens, train, generator)
        return self.encoder(txt_tokens)

    def decode(self, decoder_inp, tgt_nonpadding, train=False, generator=None):
        """The decoder and ``mel_out``: [B, T, H] -> mel [B, T, M], zero
        at the frames that are padding. The fft and conv decoders read
        their padding from the input, as in JAX; the wn and rnn decoders
        see every frame."""
        if isinstance(self.decoder, ConvBlocks):
            nonpad = (decoder_inp.abs().sum(-1, keepdim=True) > 0).to(decoder_inp.dtype)
            x = self.decoder(decoder_inp, nonpad, train, generator)
        else:
            x = self.decoder(decoder_inp)
        return self.mel_out(x) * tgt_nonpadding

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
            # with no reference mel2ph, the static frame budget (as JAX);
            # the frames past the predicted length are padding
            max_frames = (mel2ph.shape[1] if mel2ph is not None
                          else int(self.hp.get("max_frames", 1548)))
            mel2ph = length_regulator(dur, max_frames, src_padding)
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
                use_pred_pitch=False, train=False, generator=None,
                skip_decoder=False):
        """txt_tokens [B,S]; time_mel_masks [B,T,1] or None; mel2ph [B,T]
        (None with ``use_pred_mel2ph``); f0/uv [B,T] -> dict with
        ``decoder_inp`` [B,T,H], ``mel2ph``, ``dur``, pitch, and with a
        decoder (unless ``skip_decoder``) ``mel_out`` [B,T,M]. ``train``:
        dropout on, masks from ``generator``."""
        ret: dict = {}
        encoder_out = self.encode(txt_tokens, train, generator)
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
        ret["decoder_inp"] = decoder_inp = (decoder_inp + style_embed) * tgt_nonpadding
        if self.decoder is not None and not skip_decoder:
            ret["mel_out"] = self.decode(decoder_inp, tgt_nonpadding, train, generator)
        return ret
