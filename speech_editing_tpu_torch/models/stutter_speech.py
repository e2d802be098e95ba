"""StutterSpeech: the FluentSpeech masked diffusion editor with stutter
conditioning, and the standalone block-level stutter predictor; the port of
the JAX package's ``models/stutter_speech.py``.

* :class:`FrameStutterHead`: a 3-class frame classifier over the
  conditioner's states, conditioned on the mel's encoding
  (``ConditionalConvBlocks``, dropout 0.3, then a linear layer).
* :class:`StutterGaussianDiffusion`: :class:`GaussianDiffusion` whose
  conditioner also runs the head (``stutter_predictor_out``) and, in
  training, adds a learned embedding of each frame's stutter label
  (``stutter_embed``: 3 rows, none of them a zeroed padding row) to the
  decoder input. DiffNet is the same, so each pass launches K1 (and K5
  under autograd) once a block; of the model's switches it honours
  ``ref_pad_compat`` alone, as the JAX model does.
* :class:`StutterPredictor`: 16x downsampled block classifier: four
  stride-2 convs over the mel and over the frame-expanded text states,
  ``ConvBlocks`` over the mel, a ``WN`` decoder conditioned on the text,
  3 logits a block.

Parameter names: the StutterSpeech model's are the reference torch
module's, as ``convert_stutter_gaussian_diffusion`` reads them
(``fs.*``, ``mel_encoder.*``, ``stutter_embed.weight``,
``stutter_predictor.{conv,linear}.*``, ``denoise_fn.*``); the predictor's
follow its flax module names with the port's conventions (``txt_encoder``
as the conv text encoder, ``mel_prenet.convs.{i}``, ``mel_convs``,
``decoder.{in_layers,res_skip_layers,cond_layer}``, ``out_proj``).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from speech_editing_tpu_torch.models.spec_denoiser.spec_denoiser import GaussianDiffusion
from speech_editing_tpu_torch.modules.conv import (ConditionalConvBlocks, ConvBlocks,
                                                   TextConvEncoder)
from speech_editing_tpu_torch.modules.predictors import dropout as drop
from speech_editing_tpu_torch.modules.wavenet import WN
from speech_editing_tpu_torch.ops.seq_ops import expand_states
from speech_editing_tpu_torch.utils.dtypes import promoted


class FrameStutterHead(nn.Module):
    def __init__(self, hidden_size: int, odim: int = 3):
        super().__init__()
        self.conv = ConditionalConvBlocks(hidden_size, hidden_size, hidden_size, (1,) * 4, 5,
                                          layers_in_block=2, dropout=0.3)
        self.linear = nn.Linear(hidden_size, odim)

    def forward(self, x, cond, nonpadding=None, train: bool = False, generator=None):
        """x, cond [B, T, H]; nonpadding [B, T, 1] -> logits [B, T, 3]."""
        return self.linear(self.conv(x, cond, nonpadding, train, generator))


class StutterGaussianDiffusion(GaussianDiffusion):
    """``forward_train(..., stutter_labels=labels)`` trains (labels [B, T]:
    0 fluent, 1 stutter, 2 padding); ``forward`` samples as
    :class:`GaussianDiffusion` does, the labels unused."""

    def __init__(self, vocab_size: int, hp: Any, out_dims: int = 80):
        super().__init__(vocab_size, hp, out_dims)
        # of the three switches the JAX model reads only ref_pad_compat
        self.masked_cond, self.no_diffusion = True, False
        h = hp["hidden_size"]
        self.stutter_embed = nn.Embedding(3, h)
        self.stutter_predictor = FrameStutterHead(h)

    def compute_cond(self, txt_tokens, time_mel_masks, mel2ph, spk_embed,
                     ref_mels, f0, uv, use_pred_mel2ph=False, use_pred_pitch=False,
                     train=False, generator=None, masked_cond=True, stutter_labels=None):
        """The FluentSpeech conditioner, ``stutter_predictor_out`` [B, T, 3]
        of the head, and with ``stutter_labels`` their embedding added to
        the decoder input at the frames of ``mel2ph``; ``masked_cond`` as
        :meth:`GaussianDiffusion.compute_cond` takes it."""
        ret = self.fs(txt_tokens, time_mel_masks if masked_cond else None, mel2ph,
                      spk_embed, f0, uv,
                      use_pred_mel2ph=use_pred_mel2ph, use_pred_pitch=use_pred_pitch,
                      train=train, generator=generator)
        decoder_inp = ret["decoder_inp"]
        tgt_nonpadding = (ret["mel2ph"] > 0)[:, :, None].to(decoder_inp.dtype)
        stutter_cond = self.mel_encoder(ref_mels) * tgt_nonpadding
        ret["stutter_predictor_out"] = self.stutter_predictor(
            decoder_inp, stutter_cond, tgt_nonpadding, train, generator)
        if stutter_labels is not None:
            decoder_inp = decoder_inp + self.stutter_embed(stutter_labels.long()) * tgt_nonpadding
        ret["cond"] = decoder_inp + self.mel_encoder(
            ref_mels * (1 - time_mel_masks)) * tgt_nonpadding
        return ret


class ConvMelPrenet(nn.Module):
    """Four 3-wide stride-2 convs (padding 1), each with a 0.2 leaky ReLU:
    [B, T, in_dims] -> [B, T / 16, H], then a linear layer."""

    def __init__(self, in_dims: int, hidden_size: int = 192):
        super().__init__()
        self.convs = nn.ModuleList(
            nn.Conv1d(in_dims if i == 0 else hidden_size, hidden_size, 3, stride=2, padding=1)
            for i in range(4))
        self.fc_out = nn.Linear(hidden_size, hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.transpose(1, 2)
        for conv in self.convs:
            x = F.leaky_relu(conv(x), 0.2)
        return self.fc_out(x.transpose(1, 2))


class StutterPredictor(nn.Module):
    def __init__(self, vocab_size: int, hp: Any, block_size: int = 16, in_dims: int = 80):
        super().__init__()
        h = hp["hidden_size"]
        self.block_size = block_size
        self.txt_encoder = TextConvEncoder(
            vocab_size, h, h, tuple(hp["enc_dilations"]), hp["enc_kernel_size"],
            norm_type=hp.get("enc_dec_norm", "ln"),
            layers_in_block=hp.get("layers_in_block", 2),
            post_net_kernel=hp.get("enc_post_net_kernel", 3))
        self.mel_prenet = ConvMelPrenet(in_dims, h)
        self.mel_convs = ConvBlocks(h, h, (1,) * 5, kernel_size=5, layers_in_block=2)
        self.decoder_text_prenet = ConvMelPrenet(h, h)
        self.decoder = WN(h, kernel_size=5, dilation_rate=1, n_layers=4, c_cond=h,
                          dropout=0.3)
        self.out_proj = nn.Linear(h, 3, bias=False)

    def forward(self, txt_tokens, mels, mel2ph, train: bool = False,
                generator: torch.Generator | None = None) -> dict:
        """txt_tokens [B, S]; mels [B, T, 80] with T a multiple of the block
        size; mel2ph [B, T] -> ``logits`` [B, T / 16, 3]. ``train`` turns
        dropout on (0.3 on both embeddings and in the decoder), its masks
        from ``generator``."""
        b, t = mel2ph.shape
        # float32 masks, as the JAX model's: under use_bf16 the embeddings
        # they multiply, and every layer after them, compute in float32
        txt_nonpadding = (txt_tokens > 0).float()[:, :, None]
        txt_embed = self.txt_encoder(txt_tokens) * txt_nonpadding
        blocks = (mel2ph > 0).reshape(b, t // self.block_size, self.block_size)
        block_nonpadding = blocks.any(-1).float()[:, :, None]
        mel_embed = self.mel_prenet(mels)
        mel_nonpadding = (mel_embed.abs().sum(-1, keepdim=True) > 0).to(mels.dtype)
        mel_embed = self.mel_convs(mel_embed, mel_nonpadding) * block_nonpadding
        if train:
            txt_embed = drop(txt_embed, 0.3, generator)
            mel_embed = drop(mel_embed, 0.3, generator)
        condition = promoted(self.decoder_text_prenet,
                             expand_states(txt_embed, mel2ph)) * block_nonpadding
        dec = promoted(self.decoder, mel_embed, cond=condition, train=train,
                       generator=generator)
        return {"logits": promoted(self.out_proj, dec) * block_nonpadding}
