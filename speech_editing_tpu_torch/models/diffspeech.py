"""DiffSpeech: epsilon-prediction diffusion TTS over the FastSpeech
conditioner (no masks, no decoder).

The mel is normalised to [-1, 1] by ``spec_min`` / ``spec_max`` (-6 and 1.5
a bin when the config leaves them empty). Training diffuses it to a random
step and DiffNet predicts the noise; the x0 it implies, clipped to [-1, 1],
is the validation mel. The reverse process runs ``timesteps`` steps, each
clipping the implied x0 and sampling the posterior, the state masked to the
frames of ``mel2ph`` after every step. DiffNet sees no nonpadding mask, as
in the JAX package, so on the card K1 runs unmasked (and at dilation 1 for
``dilation_cycle_length: 1``). The noise is drawn from a
``torch.Generator`` on the device, or passed in (JAX's threefry draws
cannot be reproduced).
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch
from torch import nn

from speech_editing_tpu_torch.models.fs import FastSpeech
from speech_editing_tpu_torch.modules.wavenet import DiffNet
from speech_editing_tpu_torch.ops import diffusion as diff_ops
from speech_editing_tpu_torch.parallel.mesh import draw_rows


class DiffSpeech(nn.Module):
    def __init__(self, vocab_size: int, hp: Any, out_dims: int = 80):
        super().__init__()
        self.hp, self.out_dims = hp, out_dims
        self.fs = FastSpeech(vocab_size, hp, decoder=False, masked=False)
        self.denoise_fn = DiffNet(out_dims, hp["hidden_size"], hp["residual_layers"],
                                  hp["residual_channels"], hp["dilation_cycle_length"],
                                  remat=bool(hp.get("remat_diffnet", False)))
        self.num_timesteps = hp["timesteps"]
        spec_min = np.asarray(hp.get("spec_min") or [-6.0] * out_dims, np.float32)
        spec_max = np.asarray(hp.get("spec_max") or [1.5] * out_dims, np.float32)
        self.register_buffer("spec_min", torch.from_numpy(spec_min[:out_dims]), persistent=False)
        self.register_buffer("spec_max", torch.from_numpy(spec_max[:out_dims]), persistent=False)
        self._sched: dict = {}

    def schedule(self, device) -> diff_ops.DiffusionSchedule:
        key = str(device)
        if key not in self._sched:
            self._sched[key] = diff_ops.DiffusionSchedule.create(
                self.hp.get("schedule_type", "cosine"), self.num_timesteps,
                max_beta=self.hp.get("max_beta", 0.06), device=device)
        return self._sched[key]

    def norm_spec(self, x):
        return (x - self.spec_min) / (self.spec_max - self.spec_min) * 2 - 1

    def denorm_spec(self, x):
        return (x + 1) / 2 * (self.spec_max - self.spec_min) + self.spec_min

    def _eps_to_x0(self, x_t, eps, t):
        s = self.schedule(x_t.device)
        sqrt_ac = s.sqrt_alphas_cumprod[t].reshape(-1, 1, 1)
        sqrt_om = s.sqrt_one_minus_alphas_cumprod[t].reshape(-1, 1, 1)
        return (x_t - sqrt_om * eps) / sqrt_ac.clamp(min=1e-8)

    def denoise(self, x_t, t, cond, weights=None):
        """Predicted epsilon."""
        return self.denoise_fn(x_t, t, cond, None, weights)

    def compute_cond(self, txt_tokens, mel2ph=None, spk_embed=None, f0=None, uv=None):
        """The conditioner alone, durations and pitch predicted where not given."""
        return self.fs(txt_tokens, None, mel2ph, spk_embed, f0, uv,
                       use_pred_mel2ph=mel2ph is None, use_pred_pitch=f0 is None,
                       skip_decoder=True)

    def forward_train(self, txt_tokens, mel2ph, spk_embed, ref_mels, f0, uv,
                      t: torch.Tensor | None = None, noise: torch.Tensor | None = None,
                      generator: torch.Generator | None = None, train: bool = True):
        """``t`` [B] in [0, timesteps) and ``noise`` [B,T,M] drawn from
        ``generator`` when None. Returns the conditioner's dict with
        ``noise_pred``, ``noise_gt`` (both masked to the frames of
        ``mel2ph``) and ``mel_out``, the clipped x0 the prediction implies."""
        ret = self.fs(txt_tokens, None, mel2ph, spk_embed, f0, uv, train=train,
                      generator=generator, skip_decoder=True)
        cond = ret["decoder_inp"]
        tgt_nonpadding = (ret["mel2ph"] > 0)[:, :, None].to(cond.dtype)
        x_start = self.norm_spec(ref_mels)
        b = txt_tokens.shape[0]
        # drawn for the global batch under data parallelism, this rank's rows kept
        if t is None:
            t = draw_rows(b, lambda n: torch.randint(0, self.num_timesteps, (n,),
                                                     device=cond.device, generator=generator))
        if noise is None:
            noise = draw_rows(b, lambda n: torch.randn((n,) + tuple(x_start.shape[1:]),
                                                       device=cond.device, generator=generator))
        x_t = diff_ops.q_sample(self.schedule(cond.device), x_start, t, noise)
        eps = self.denoise(x_t * tgt_nonpadding, t, cond)
        ret["noise_pred"] = eps * tgt_nonpadding
        ret["noise_gt"] = noise * tgt_nonpadding
        x0 = self._eps_to_x0(x_t, eps, t).clamp(-1, 1)
        ret["mel_out"] = self.denorm_spec(x0) * tgt_nonpadding
        return ret

    def forward(self, txt_tokens, mel2ph=None, spk_embed=None, f0=None, uv=None,
                generator: torch.Generator | None = None,
                noise: Sequence[torch.Tensor] | None = None, mask_steps: bool = True):
        """Inference: durations and pitch predicted where ``mel2ph`` / ``f0``
        are None (then over ``max_frames`` frames, as JAX). ``noise``:
        timesteps+1 tensors [B,T,M], the initial state and then the noise of
        steps T-1 .. 0; drawn from ``generator`` when None. ``mask_steps``
        False leaves the state unmasked between steps, as the JAX task's
        ``p_sample_loop`` (``build_infer_fn``) runs it. Returns the
        conditioner's dict with ``mel_out`` [B,T,M]."""
        ret = self.compute_cond(txt_tokens, mel2ph, spk_embed, f0, uv)
        cond = ret["decoder_inp"]
        nonpad = (ret["mel2ph"] > 0)[:, :, None].to(cond.dtype)
        b, t_mel = cond.shape[:2]
        big_t = self.num_timesteps
        if noise is None:
            noise = [torch.randn(b, t_mel, self.out_dims, device=cond.device,
                                 generator=generator) for _ in range(big_t + 1)]
        if len(noise) != big_t + 1:
            raise ValueError(f"noise: {len(noise)} tensors, expected {big_t + 1}")
        sched = self.schedule(cond.device)
        weights = self.denoise_fn.kernel_weights()
        step_mask = nonpad if mask_steps else 1.0
        x = noise[0] * step_mask
        for i in range(big_t - 1, -1, -1):
            t = torch.full((b,), i, dtype=torch.long, device=cond.device)
            x0 = self._eps_to_x0(x, self.denoise(x, t, cond, weights), t).clamp(-1, 1)
            x = diff_ops.q_posterior_sample(sched, x0, x, t, noise[big_t - i]) * step_mask
        ret["mel_out"] = self.denorm_spec(x) * nonpad
        return ret
