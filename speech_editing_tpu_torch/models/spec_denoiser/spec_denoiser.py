"""FluentSpeech masked-conditional mel DDPM: inference and the training
forward.

Conditioning: FastSpeech states expanded to frame rate (with the masked
duration/pitch conditioning) plus ``MelEncoder(ref_mels * (1 - mask))``.
The reverse process runs ``timesteps`` steps of the x0-predicting DiffNet;
its noise is drawn from a ``torch.Generator`` on the device, or passed in.
Training (:meth:`GaussianDiffusion.forward_train`) diffuses the target mel
to a random step and predicts x0 from it in one DiffNet pass.

The model's own forwards (training and ``forward``) honour three switches
of the JAX package's model, which the edit drivers' :meth:`compute_cond`
reads none of: ``use_masked_cond: false`` gives the conditioner no masks
(the duration and pitch predictors then see no masked ground truth);
``ref_pad_compat`` gives DiffNet no nonpadding mask (its convs then see
the padded frames, as the reference's do); ``no_diffusion`` maps the
conditioning to mel in one DiffNet call on zeros at step 0.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from speech_editing_tpu_torch.models.fs import FastSpeech
from speech_editing_tpu_torch.modules.predictors import MelEncoder
from speech_editing_tpu_torch.modules.wavenet import DiffNet
from speech_editing_tpu_torch.ops import diffusion as diff_ops
from speech_editing_tpu_torch.parallel.mesh import draw_rows
from speech_editing_tpu_torch.utils.dtypes import promoted


class GaussianDiffusion(nn.Module):
    def __init__(self, vocab_size: int, hp: Any, out_dims: int = 80):
        super().__init__()
        self.hp = hp
        self.masked_cond = bool(hp.get("use_masked_cond", True))
        self.no_diffusion = bool(hp.get("no_diffusion"))
        self.ref_pad_compat = bool(hp.get("ref_pad_compat"))
        self.out_dims = out_dims
        self.fs = FastSpeech(vocab_size, hp)
        self.mel_encoder = MelEncoder(out_dims, hp["hidden_size"])
        self.denoise_fn = DiffNet(out_dims, hp["hidden_size"], hp["residual_layers"],
                                  hp["residual_channels"], hp["dilation_cycle_length"],
                                  remat=bool(hp.get("remat_diffnet", False)))
        self.num_timesteps = hp["timesteps"]
        self._sched: dict = {}

    def schedule(self, device) -> diff_ops.DiffusionSchedule:
        key = str(device)
        if key not in self._sched:
            self._sched[key] = diff_ops.DiffusionSchedule.create(
                self.hp.get("schedule_type", "vpsde"), self.num_timesteps,
                device=device)
        return self._sched[key]

    def predict_durations(self, txt_tokens, time_mel_masks, masked_mel2ph,
                          masked_dur, spk_embed=None):
        """Encoder + style on the edited tokens, duration predictor conditioned
        on the masked ground-truth durations, regulated to a predicted mel2ph."""
        encoder_out = self.fs.encoder(txt_tokens)
        src_nonpadding = (txt_tokens > 0)[:, :, None].to(encoder_out.dtype)
        style_embed = self.fs.forward_style_embed(spk_embed, None)
        ret: dict = {}
        mel2ph = self.fs.forward_dur((encoder_out + style_embed) * src_nonpadding,
                                     time_mel_masks, masked_mel2ph, txt_tokens, ret,
                                     masked_dur=masked_dur, use_pred_mel2ph=True)
        return {"mel2ph": mel2ph, "dur": ret["dur"]}

    def compute_cond(self, txt_tokens, time_mel_masks, mel2ph, spk_embed,
                     ref_mels, f0, uv, use_pred_mel2ph=False, use_pred_pitch=False,
                     train=False, generator=None, masked_cond=True):
        """Conditioner only: FastSpeech states + the masked-mel encoding.
        ``train`` turns predictor dropout on, masks from ``generator``;
        ``masked_cond`` False gives FastSpeech no masks."""
        fs_masks = time_mel_masks if masked_cond else None
        ret = self.fs(txt_tokens, fs_masks, mel2ph, spk_embed, f0, uv,
                      use_pred_mel2ph=use_pred_mel2ph, use_pred_pitch=use_pred_pitch,
                      train=train, generator=generator)
        tgt_nonpadding = (ret["mel2ph"] > 0)[:, :, None].to(ret["decoder_inp"].dtype)
        ret["cond"] = ret["decoder_inp"] + self.mel_encoder(
            ref_mels * (1 - time_mel_masks)) * tgt_nonpadding
        return ret

    def forward_train(self, txt_tokens, time_mel_masks, mel2ph, spk_embed,
                      ref_mels, f0, uv, t: torch.Tensor | None = None,
                      noise: torch.Tensor | None = None,
                      generator: torch.Generator | None = None,
                      train: bool = True, **cond_kw):
        """The training branch: ``t`` [B] in [0, timesteps] and ``noise``
        [B,T,M] are drawn from ``generator`` when None (JAX's threefry draws
        cannot be reproduced, so tests pass them in); ``x_t`` is the
        q-sample of ``ref_mels``, masked to the frames of ``mel2ph``, and
        DiffNet predicts x0. ``train`` turns predictor dropout on;
        ``cond_kw`` goes to :meth:`compute_cond`. Returns the conditioner's
        dict with ``mel_out`` [B,T,M] (the x0 prediction); under
        ``no_diffusion`` the one-shot prediction, no draw made."""
        ret = self.compute_cond(txt_tokens, time_mel_masks, mel2ph, spk_embed,
                                ref_mels, f0, uv, train=train, generator=generator,
                                masked_cond=self.masked_cond, **cond_kw)
        cond = ret["cond"]
        tgt_nonpadding = (ret["mel2ph"] > 0)[:, :, None].to(cond.dtype)
        if self.no_diffusion:
            ret["mel_out"] = self.one_shot(cond, tgt_nonpadding)
            return ret
        b = txt_tokens.shape[0]
        # drawn for the global batch under data parallelism, this rank's rows kept
        if t is None:
            t = draw_rows(b, lambda n: torch.randint(0, self.num_timesteps + 1, (n,),
                                                     device=cond.device, generator=generator))
        if noise is None:
            noise = draw_rows(b, lambda n: torch.randn(
                (n,) + tuple(ref_mels.shape[1:]), device=cond.device, dtype=ref_mels.dtype,
                generator=generator))
        x_t = diff_ops.diffuse(self.schedule(cond.device), ref_mels, t,
                               noise) * tgt_nonpadding
        ret["mel_out"] = self.denoise_fn(x_t, t, cond,
                                         self.diffnet_mask(tgt_nonpadding[..., 0])
                                         ) * tgt_nonpadding
        return ret

    def diffnet_mask(self, nonpad: torch.Tensor) -> torch.Tensor | None:
        """DiffNet's nonpadding mask [B,T]: None under ``ref_pad_compat``."""
        return None if self.ref_pad_compat else nonpad

    def one_shot(self, cond: torch.Tensor, tgt_nonpadding: torch.Tensor) -> torch.Tensor:
        """``no_diffusion``: DiffNet on float32 zeros at step 0, times
        ``tgt_nonpadding`` [B,T,1]. As flax promotes, a bf16 model then runs
        DiffNet in float32 on its bf16 weights."""
        b, t_mel = cond.shape[:2]
        x0 = torch.zeros(b, t_mel, self.out_dims, device=cond.device)
        t0 = torch.zeros(b, dtype=torch.long, device=cond.device)
        return promoted(self.denoise_fn, x0, t0, cond,
                        self.diffnet_mask(tgt_nonpadding[..., 0])) * tgt_nonpadding

    def forward(self, txt_tokens, time_mel_masks, mel2ph, spk_embed, ref_mels,
                f0, uv, use_pred_mel2ph: bool = False, use_pred_pitch: bool = False,
                generator: torch.Generator | None = None,
                noise: Sequence[torch.Tensor] | None = None):
        """Inference. txt_tokens [B,S]; time_mel_masks [B,T,1]; mel2ph [B,T];
        ref_mels [B,T,M]; f0/uv [B,T]. ``noise``: timesteps+1 tensors
        [B,T,M], the initial noise (step T) and then the noise of steps
        T-1 .. 0; drawn from ``generator`` when None. Returns the
        conditioner's dict with ``mel_out`` [B,T,M]; under ``no_diffusion``
        the one-shot prediction, no noise used."""
        ret = self.compute_cond(txt_tokens, time_mel_masks, mel2ph, spk_embed,
                                ref_mels, f0, uv, use_pred_mel2ph, use_pred_pitch,
                                masked_cond=self.masked_cond)
        cond = ret["cond"]
        nonpad = (ret["mel2ph"] > 0).to(cond.dtype)             # [B, T]
        if self.no_diffusion:
            ret["mel_out"] = self.one_shot(cond, nonpad[..., None])
            return ret
        b, t_mel = cond.shape[:2]
        big_t = self.num_timesteps
        if noise is None:
            noise = [torch.randn(b, t_mel, self.out_dims, device=cond.device,
                                 generator=generator) for _ in range(big_t + 1)]
        if len(noise) != big_t + 1:
            raise ValueError(f"noise: {len(noise)} tensors, expected {big_t + 1}")
        sched = self.schedule(cond.device)
        weights = self.denoise_fn.kernel_weights()
        mask = self.diffnet_mask(nonpad)
        x = noise[0] * nonpad[..., None]
        for i in range(big_t - 1, -1, -1):
            t = torch.full((b,), i, dtype=torch.long, device=cond.device)
            x0_pred = self.denoise_fn(x, t, cond, mask, weights)
            x = diff_ops.q_posterior_sample(sched, x0_pred, x, t,
                                            noise[big_t - i]) * nonpad[..., None]
        ret["mel_out"] = x
        return ret
