"""Flax's parameter initializers on the port's modules.

The JAX package draws its starting weights through ``model.init``; the
port's modules take torch's defaults when built. :func:`init_like_flax`
redraws every parameter from the distribution flax gives the same
parameter (the same distributions, not the same draws):

* token embeddings: normal with std dim^-0.5 (``TokenEmbedding``);
* dense layers, convolutions, attention projections: lecun-normal (a
  normal truncated at two standard deviations with variance 1 / fan_in,
  a transposed convolution's fan_in its input channels times its width,
  as flax counts it), zero biases;
* LayerNorm and GroupNorm: scale one, bias zero;
* DiffNet's convolutions: kaiming-normal (variance 2 / fan_in, truncated),
  its final ``output_projection`` zero, so the first x0 prediction is 0;
* the conv text encoder's convolutions: xavier-uniform;
* HiFi-GAN's convolutions after ``conv_pre``: normal with std 0.01;
* LSTMs (``OptimizedLSTMCell``) and GRUs (``GRUCell``): each gate's input
  kernel lecun-normal, its recurrent kernel orthogonal, biases zero;
* the conformer's ``pos_bias_u``/``pos_bias_v``: variance scaling 1.0 over
  fan_avg, uniform; its depthwise and 1-wide convolutions lecun-normal
  (fan_in = kernel x input channels of a group); BatchNorm's affine one and
  zero with running statistics 0 and 1;
* CampNet's ``mask_emb`` zero and the decoder's ``pos_embed_alpha`` one;
* the relative-window encoder's prenet projection zero (its relative
  embeddings keep the normal draw with std d^-0.5 they are built with);
* StutterSpeech's ``stutter_embed`` (an embedding: normal with std
  dim^-0.5), its frame head's convolutions (``ConditionalConvBlocks``, its
  ``g_prenet`` too) xavier-uniform; the stutter predictor's stride-2
  prenets and ``WN`` convolutions lecun-normal, its ``ConvBlocks``
  xavier-uniform;
* the flows' 1x1 products orthogonal and ActNorms zero (as built), each
  affine coupling's output layer zero.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from speech_editing_tpu_torch.models.campnet import CampNet
from speech_editing_tpu_torch.models.vocoder.hifigan import HifiGanGenerator
from speech_editing_tpu_torch.modules.conformer import RelPositionMultiHeadAttention
from speech_editing_tpu_torch.modules.conv import ConvBlocks
from speech_editing_tpu_torch.modules.flows import _AffineCoupling, zero_post
from speech_editing_tpu_torch.modules.rel_transformer import ConvReluNorm
from speech_editing_tpu_torch.modules.transformer import MultiheadAttention, TransformerDecoder
from speech_editing_tpu_torch.modules.wavenet import DiffNet

# the std of a standard normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _variance_scaling_normal_(w: torch.Tensor, scale: float) -> None:
    """jax's ``variance_scaling(scale, "fan_in", "truncated_normal")``."""
    fan_in = nn.init._calculate_fan_in_and_fan_out(w)[0]
    std = math.sqrt(scale / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std)


def _reset(layer: nn.Module, init) -> None:
    init(layer.weight)
    if layer.bias is not None:
        nn.init.zeros_(layer.bias)


def _fan_avg_uniform_(w: torch.Tensor) -> None:
    """jax's ``variance_scaling(1.0, "fan_avg", "uniform")`` of a 2-axis
    parameter [fan_in, fan_out]."""
    limit = math.sqrt(3.0 / ((w.shape[0] + w.shape[1]) / 2))
    nn.init.uniform_(w, -limit, limit)


def _recurrent_(rnn: nn.LSTM | nn.GRU) -> None:
    """Each gate's block of the stacked weights as flax's cell draws it."""
    h = rnn.hidden_size
    gates = 4 if isinstance(rnn, nn.LSTM) else 3
    for name, w in rnn.named_parameters():
        if name.startswith("bias"):
            nn.init.zeros_(w)
            continue
        for g in range(gates):
            block = w[g * h:(g + 1) * h]    # [H, in]: flax's kernel [in, H] transposed
            if name.startswith("weight_hh"):
                nn.init.orthogonal_(block)
            else:
                lecun_normal_(block)


def lecun_normal_(w: torch.Tensor) -> None:
    _variance_scaling_normal_(w, 1.0)


def kaiming_normal_(w: torch.Tensor) -> None:
    _variance_scaling_normal_(w, 2.0)


@torch.no_grad()
def init_like_flax(model: nn.Module) -> nn.Module:
    """Redraw every parameter of ``model`` as flax initializes it (see the
    module doc) from torch's global generator; returns ``model``."""
    for m in model.modules():
        if isinstance(m, nn.Embedding):
            nn.init.normal_(m.weight, std=m.embedding_dim ** -0.5)
        elif isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            _reset(m, lecun_normal_)
        elif isinstance(m, nn.ConvTranspose1d):   # torch's weight [in, out, k]
            _reset(m, lambda w: _variance_scaling_normal_(w.transpose(0, 1), 1.0))
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm1d)):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
            if isinstance(m, nn.BatchNorm1d):
                m.reset_running_stats()
        elif isinstance(m, (nn.LSTM, nn.GRU)):
            _recurrent_(m)
        elif isinstance(m, RelPositionMultiHeadAttention):
            _fan_avg_uniform_(m.pos_bias_u)
            _fan_avg_uniform_(m.pos_bias_v)
        elif isinstance(m, MultiheadAttention):
            lecun_normal_(m.in_proj_weight)
    # modules whose flax counterparts name their own initializers
    for m in model.modules():
        if isinstance(m, DiffNet):
            for layer in (m.input_projection, m.skip_projection):
                _reset(layer, kaiming_normal_)
            for block in m.residual_layers:
                for layer in (block.dilated_conv, block.conditioner_projection,
                              block.output_projection):
                    _reset(layer, kaiming_normal_)
            _reset(m.output_projection, nn.init.zeros_)
        elif isinstance(m, ConvBlocks):
            for layer in m.modules():
                if isinstance(layer, nn.Conv1d):
                    _reset(layer, nn.init.xavier_uniform_)
        elif isinstance(m, ConvReluNorm):
            _reset(m.proj, nn.init.zeros_)
        elif isinstance(m, CampNet):
            nn.init.zeros_(m.mask_emb)
        elif isinstance(m, TransformerDecoder):
            nn.init.ones_(m.pos_embed_alpha)
        elif isinstance(m, _AffineCoupling):
            zero_post(m)
        elif isinstance(m, HifiGanGenerator):
            for layer in m.modules():
                if isinstance(layer, (nn.Conv1d, nn.ConvTranspose1d)) and layer is not m.conv_pre:
                    _reset(layer, lambda w: nn.init.normal_(w, std=0.01))
    return model
