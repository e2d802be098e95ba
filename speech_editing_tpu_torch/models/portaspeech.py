"""PortaSpeech: a word-level linguistic encoder and a VAE frame decoder,
and PortaSpeech-flow, which adds a Glow post-flow over the mel; the port
of the JAX package's ``models/portaspeech.py``.

* :class:`FVAE`: a strided conv encoder (stride ``s``, flax's explicit
  padding ``(s // 2, 2s - s // 2 - 1)``) to a latent at 1/s of the frame
  rate, ``WN`` posterior and decoder conditioned on the decoder input (the
  posterior on its strided copy), an optional ``ResFlow`` prior, and the KL
  against N(0, 1) or through the flow. The decoder's first layer is flax's
  ``ConvTranspose`` with kernel = stride, which does not flip its kernel:
  the converter flips it into torch's ``ConvTranspose1d``.
* :class:`PortaSpeech`: the phone encoder (K3, K4 under autograd), the
  word encoder applied twice (as JAX does: into the phone states and onto
  the word states), the mean of each word's phone states through
  ``ph2word_encoder`` (K3), word durations as the segment sums of the
  phone durations, the word-window attention (a masked softmax over
  [B, T_mel, S_ph], plain products: its weights are returned as
  ``attn``), the post-attention residuals and the FVAE.
* :class:`PortaSpeechFlow`: the Glow post-flow conditioned on
  [decoder input ; the FVAE's mel, detached]: its NLL in training, a
  sample run in reverse at inference.

Each random draw is an optional argument, drawn from ``generator`` for
the global batch (``parallel/mesh.py::draw_rows``) when None: the
posterior's ``eps``, the ``posterior_start_steps`` warm-up's
``warm_noise``, the prior's ``z_prior`` and the post-flow's ``z_flow``
(the last two standard normal, scaled by the noise scale here). Tensors
are ``[B, T, C]``.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from speech_editing_tpu_torch.models.fs import StyleEmbedMixin
from speech_editing_tpu_torch.modules.conv import ConvBlocks
from speech_editing_tpu_torch.modules.flows import Glow, ResFlow
from speech_editing_tpu_torch.modules.predictors import DurationPredictor
from speech_editing_tpu_torch.modules.transformer import (FastSpeechEncoder, FFTBlocks,
                                                          TokenEmbedding)
from speech_editing_tpu_torch.modules.wavenet import WN
from speech_editing_tpu_torch.ops.seq_ops import (build_word_mask, clip_mel2token_to_multiple,
                                                  expand_states, group_hidden_by_segs,
                                                  length_regulator, predictor_grad_scale,
                                                  segment_sum)
from speech_editing_tpu_torch.parallel.mesh import draw_rows, global_mean
from speech_editing_tpu_torch.training.losses import ratio

_LOG_2PI = math.log(2 * math.pi)


def sinusoidal_pos_emb(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Continuous positions [B, T] -> [B, T, dim]: [sin | cos]."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, device=x.device, dtype=torch.float32)
                      * -(math.log(10000) / (half - 1)))
    ang = x[:, :, None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


def normal(shape, like: torch.Tensor, generator=None, given=None) -> torch.Tensor:
    """``given``, or a standard normal draw of ``shape`` for the global
    batch from ``generator``."""
    if given is not None:
        return given
    return draw_rows(shape[0], lambda n: torch.randn(
        (n,) + tuple(shape[1:]), generator=generator, device=like.device, dtype=like.dtype))


def _strided_conv(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` (kernel 2s, stride s) over [B, T, C] with flax's explicit
    padding (s // 2, 2s - s // 2 - 1)."""
    s = conv.stride[0]
    return conv(F.pad(x.transpose(1, 2), (s // 2, 2 * s - s // 2 - 1))).transpose(1, 2)


class FVAEEncoder(nn.Module):
    def __init__(self, c_in: int, hidden_size: int, c_latent: int, kernel_size: int,
                 n_layers: int, c_cond: int, stride: int):
        super().__init__()
        self.stride, self.c_latent = stride, c_latent
        self.pre = nn.Conv1d(c_in, hidden_size, 2 * stride, stride=stride)
        self.wn = WN(hidden_size, kernel_size, 1, n_layers, c_cond)
        self.out_proj = nn.Linear(hidden_size, 2 * c_latent)

    def forward(self, x, nonpadding, cond, generator=None, eps=None):
        """-> (z, m, logs, the strided nonpadding [B, T // s, 1])."""
        t_sqz = nonpadding.shape[1] // self.stride
        np_sqz = nonpadding[:, ::self.stride][:, :t_sqz]
        x = _strided_conv(self.pre, x)[:, :t_sqz] * np_sqz
        x = self.wn(x, np_sqz, cond) * np_sqz
        out = self.out_proj(x)
        m, logs = out[..., :self.c_latent], out[..., self.c_latent:]
        z = m + normal(m.shape, m, generator, eps) * torch.exp(logs)
        return z, m, logs, np_sqz


class FVAEDecoder(nn.Module):
    def __init__(self, c_latent: int, hidden_size: int, out_channels: int, kernel_size: int,
                 n_layers: int, c_cond: int, stride: int):
        super().__init__()
        self.pre = nn.ConvTranspose1d(c_latent, hidden_size, stride, stride=stride)
        self.wn = WN(hidden_size, kernel_size, 1, n_layers, c_cond)
        self.out_proj = nn.Linear(hidden_size, out_channels)

    def forward(self, z, nonpadding, cond):
        x = self.pre(z.transpose(1, 2)).transpose(1, 2) * nonpadding
        return self.out_proj(self.wn(x, nonpadding, cond) * nonpadding)


class FVAE(nn.Module):
    def __init__(self, c_in_out: int, hidden_size: int, c_latent: int, kernel_size: int,
                 enc_n_layers: int, dec_n_layers: int, c_cond: int, stride: int,
                 use_prior_flow: bool, flow_hidden: int = 64, flow_kernel_size: int = 3,
                 flow_n_steps: int = 4):
        super().__init__()
        self.stride, self.c_latent = stride, c_latent
        self.g_pre_net = nn.Conv1d(c_cond, c_cond, 2 * stride, stride=stride)
        self.encoder = FVAEEncoder(c_in_out, hidden_size, c_latent, kernel_size, enc_n_layers,
                                   c_cond, stride)
        self.decoder = FVAEDecoder(c_latent, hidden_size, c_in_out, kernel_size, dec_n_layers,
                                   c_cond, stride)
        self.prior_flow = (ResFlow(c_latent, flow_hidden, flow_kernel_size, flow_n_steps,
                                   c_cond=c_cond) if use_prior_flow else None)

    def forward(self, x, nonpadding, cond, infer: bool = False, noise_scale: float = 1.0,
                generator=None, eps=None, z_prior=None) -> dict:
        """x [B, T, M] (None at inference); nonpadding [B, T, 1]; cond
        [B, T, H]. Training: the posterior's sample ``z_q`` and the KL
        (over the global batch's frames); inference: the prior's sample."""
        t_sqz = nonpadding.shape[1] // self.stride
        g = _strided_conv(self.g_pre_net, cond)[:, :t_sqz]
        if not infer:
            z_q, m_q, logs_q, np_sqz = self.encoder(x, nonpadding, g, generator, eps)
            if self.prior_flow is not None:
                logqx = (-0.5 * (_LOG_2PI + 2 * logs_q)
                         - 0.5 * ((z_q - m_q) / torch.exp(logs_q)) ** 2)
                z_p = self.prior_flow(z_q, np_sqz, g)
                logpx = -0.5 * (_LOG_2PI + z_p ** 2)
                kl_map = logqx - logpx
            else:
                kl_map = -logs_q - 0.5 + 0.5 * (torch.exp(2 * logs_q) + m_q ** 2)
                z_p = None
            kl = ratio((kl_map * np_sqz).sum(), np_sqz.sum()) / kl_map.shape[-1]
            return {"z_q": z_q, "kl": kl, "z_p": z_p, "m_q": m_q, "logs_q": logs_q,
                    "np_sqz": np_sqz, "g": g}
        z_p = normal((g.shape[0], t_sqz, self.c_latent), g, generator, z_prior) * noise_scale
        if self.prior_flow is not None:
            np_sqz = nonpadding[:, ::self.stride][:, :t_sqz]
            z_p = self.prior_flow(z_p, np_sqz, g, reverse=True)
        return {"z_q": z_p, "g": g}


class PortaSpeech(StyleEmbedMixin, nn.Module):
    """Phone and word encoders, word-level durations, word-window attention
    to the frame rate and the FVAE decoder (see the module doc)."""

    def __init__(self, vocab_size: int, word_dict_size: int, hp: Any, out_dims: int = 80):
        super().__init__()
        self.hp, self.out_dims = hp, out_dims
        h = self.hidden_size = hp["hidden_size"]
        self.encoder = FastSpeechEncoder(vocab_size, h, hp["enc_layers"],
                                         hp["enc_ffn_kernel_size"], hp["num_heads"])
        self.use_word_encoder = hp.get("use_word_encoder", True)
        if self.use_word_encoder:
            self.word_encoder = FastSpeechEncoder(word_dict_size, h, hp.get("word_enc_layers", 4),
                                                  hp["enc_ffn_kernel_size"], 2)
        self.ph2word_encoder = FFTBlocks(h, hp.get("word_enc_layers", 4), 1, hp["num_heads"])
        self.enc_pos_proj = nn.Linear(2 * h, h)
        self.dec_res_proj = nn.Linear(2 * h, h)
        self.attn_q = nn.Linear(h, h, bias=False)
        self.attn_k = nn.Linear(h, h, bias=False)
        self.attn_v = nn.Linear(h, h, bias=False)
        self.text_encoder_postnet = (ConvBlocks(h, h, (1,) * 3, 5, layers_in_block=2)
                                     if hp.get("text_encoder_postnet", True) else None)
        self.dur_predictor = DurationPredictor(h, h, hp["dur_predictor_layers"],
                                               hp["dur_predictor_kernel"], hp["predictor_dropout"])
        self.fvae = FVAE(out_dims, hp.get("fvae_enc_dec_hidden", 192), hp.get("latent_size", 16),
                         hp.get("fvae_kernel_size", 5), hp.get("fvae_enc_n_layers", 8),
                         hp.get("fvae_dec_n_layers", 4), h, hp.get("fvae_strides", 4),
                         hp.get("use_prior_flow", True), hp.get("prior_flow_hidden", 64),
                         hp.get("prior_flow_kernel_size", 3), hp.get("prior_flow_n_blocks", 4))
        if hp.get("use_pitch_embed"):
            self.pitch_embed = TokenEmbedding(300, h)
        if hp.get("use_spk_embed"):
            self.spk_embed_proj = nn.Linear(256, h)
        if hp.get("use_spk_id"):
            self.spk_id_proj = TokenEmbedding(hp["num_spk"], h, padding_idx=-1)
        self.word_pos_proj = nn.Linear(h, h) if hp.get("add_word_pos", True) else None

    def get_pos_embed(self, word2word, x2word):
        """The position of each x inside its word, in (0, 1], embedded."""
        x_pos = build_word_mask(word2word, x2word).float()
        x_pos = (torch.cumsum(x_pos, -1) / x_pos.sum(-1, keepdim=True).clamp(min=1.0)
                 * x_pos).sum(1)
        return sinusoidal_pos_emb(x_pos, self.hidden_size)

    def forward(self, txt_tokens, word_tokens, ph2word, mel2word=None, spk_embed=None,
                spk_id=None, pitch=None, tgt_mels=None, infer: bool = False,
                train: bool = False, generator=None, noise_scale: float = 0.8,
                global_step=None, eps=None, warm_noise=None, z_prior=None) -> dict:
        """txt_tokens [B, S_ph]; word_tokens [B, S_w]; ph2word [B, S_ph];
        mel2word [B, T] (None: regulated from the predicted word
        durations to ``max_frames``); tgt_mels [B, T, M] in training.
        ``train``: dropout on, its masks from ``generator``."""
        hp = self.hp
        ret: dict = {}
        word_len = word_tokens.shape[1]
        style = self.forward_style_embed(spk_embed, spk_id)
        src_nonpadding = (txt_tokens > 0)[:, :, None].float()
        ph_out = self.encoder(txt_tokens) * src_nonpadding + style
        if self.use_word_encoder:
            ph_out = ph_out + expand_states(self.word_encoder(word_tokens) + style, ph2word)

        h_word = self.ph2word_encoder(group_hidden_by_segs(ph_out, ph2word, word_len)[0])
        if self.use_word_encoder:
            h_word = h_word + self.word_encoder(word_tokens)

        dur_inp = predictor_grad_scale(ph_out, hp.get("predictor_grad", 0.1))
        dur_ph = self.dur_predictor(dur_inp, txt_tokens == 0, train, generator)
        ret["dur"] = segment_sum(dur_ph, ph2word, word_len + 1)[:, 1:]
        if mel2word is None:
            mel2word = length_regulator(ret["dur"], int(hp.get("max_frames", 1548)),
                                        word_tokens == 0).detach()
        mel2word = clip_mel2token_to_multiple(mel2word, hp.get("frames_multiple", 1))
        ret["mel2word"] = mel2word
        tgt_nonpadding = (mel2word > 0)[:, :, None].float()

        # word-window attention: the frames' word states and in-word
        # positions query the phones of their own word
        word2word = torch.arange(1, word_len + 1, device=word_tokens.device)[None].expand_as(
            word_tokens)
        enc_pos = self.get_pos_embed(word2word, ph2word)
        dec_pos = self.get_pos_embed(word2word, mel2word)
        ph_kv = self.enc_pos_proj(torch.cat([ph_out, enc_pos], -1))
        word_exp = expand_states(h_word, mel2word)
        q_inp = self.dec_res_proj(torch.cat([word_exp, dec_pos], -1))
        if self.text_encoder_postnet is not None:
            nonpad = (q_inp.abs().sum(-1, keepdim=True) > 0).float()
            q_inp = self.text_encoder_postnet(q_inp, nonpad, train, generator)
        scores = torch.matmul(self.attn_q(q_inp), self.attn_k(ph_kv).transpose(1, 2))
        scores = scores / math.sqrt(self.hidden_size)
        scores = torch.where(build_word_mask(mel2word, ph2word) > 0, scores,
                             torch.full_like(scores, -1e9))
        weight = torch.softmax(scores, -1)
        x = torch.matmul(weight, self.attn_v(ph_kv)) + q_inp
        ret["attn"] = weight
        if self.word_pos_proj is not None:
            x = x + self.word_pos_proj(dec_pos)
        if self.use_word_encoder:
            x = x + word_exp
        x = x * tgt_nonpadding
        if hp.get("use_pitch_embed") and pitch is not None:
            x = x + self.pitch_embed(pitch[:, :x.shape[1]].long())
        ret["decoder_inp"] = x
        ret["nonpadding"] = tgt_nonpadding

        if not infer:
            fv = self.fvae(tgt_mels[:, :x.shape[1]], tgt_nonpadding, x, generator=generator,
                           eps=eps)
            ret["kl"] = fv["kl"]
            z = fv["z_q"]
            pss = int(hp.get("posterior_start_steps", 0))
            if pss > 0 and global_step is not None:
                # decode from noise until the posterior is trusted
                z = torch.where(torch.as_tensor(global_step, device=z.device) < pss,
                                normal(z.shape, z, generator, warm_noise), z)
        else:
            z = self.fvae(None, tgt_nonpadding, x, infer=True, noise_scale=noise_scale,
                          generator=generator, z_prior=z_prior)["z_q"]
            ret["kl"] = 0.0
        mel = self.fvae.decoder(z, tgt_nonpadding, x) * tgt_nonpadding
        ret["mel_out_fvae"] = ret["mel_out"] = mel
        return ret


class PortaSpeechFlow(PortaSpeech):
    """PortaSpeech and the Glow post-flow (``post_glow_*``, 3 WN layers a
    coupling): ``postflow_nll`` in training; at inference, with
    ``infer_post_glow``, ``mel_out`` is a sample (noise scaled by
    ``hp["noise_scale"]``) run back through the flow."""

    def __init__(self, vocab_size: int, word_dict_size: int, hp: Any, out_dims: int = 80):
        super().__init__(vocab_size, word_dict_size, hp, out_dims)
        h = hp["hidden_size"]
        self.post_flow_cond_proj = nn.Linear(h + out_dims, h)
        self.post_flow = Glow(out_dims, hp.get("post_glow_hidden", 128),
                              hp.get("post_glow_kernel_size", 3), hp.get("post_glow_n_blocks", 8),
                              n_layers=3, c_cond=h, sigmoid_scale=hp.get("sigmoid_scale", False))

    def forward(self, *args, infer: bool = False, infer_post_glow: bool = True, z_flow=None,
                **kwargs) -> dict:
        ret = super().forward(*args, infer=infer, **kwargs)
        nonpadding = ret["nonpadding"]
        cond = self.post_flow_cond_proj(torch.cat([ret["decoder_inp"],
                                                   ret["mel_out_fvae"].detach()], -1))
        if not infer:
            tgt = kwargs["tgt_mels"][:, :nonpadding.shape[1]]
            z, logdet = self.post_flow(tgt, nonpadding, cond)
            logp = (-0.5 * (z ** 2 + _LOG_2PI) * nonpadding).sum((1, 2))
            denom = (nonpadding.sum((1, 2)) * self.out_dims).clamp(min=1.0)
            ret["postflow_nll"] = global_mean(-(logp + logdet) / denom)
        elif infer_post_glow:
            z = normal((cond.shape[0], cond.shape[1], self.out_dims), cond,
                       kwargs.get("generator"), z_flow) * self.hp.get("noise_scale", 0.8)
            ret["mel_out"] = self.post_flow(z, nonpadding, cond, reverse=True)[0] * nonpadding
        return ret
