"""A3T task: masked mel losses on the decoder's and the postnet's output;
the port of the JAX package's ``training/tasks/a3t.py``.

The model has no dropout (its JAX twin's conformer and postnet rates are
all 0) and no kernel of its own. Its norms are LayerNorms unless
``espnet_bn_affine``, whose ``AffineNorm`` computes from its stored
statistics in training too. ``--infer`` composites ``mel_out_postnet``
inside the mask.
"""

from __future__ import annotations

from typing import Any

import torch

from speech_editing_tpu_torch.models.a3t import A3T
from speech_editing_tpu_torch.training.losses import add_mel_loss
from speech_editing_tpu_torch.training.tasks.base import BaseTask
from speech_editing_tpu_torch.utils.convert_jax_params import a3t_params_from_jax
from speech_editing_tpu_torch.utils.init import init_like_flax


class A3TTask(BaseTask):
    array_batch_keys = ("txt_tokens", "mels", "mel2ph", "time_mel_masks")

    def build_model(self) -> A3T:
        return init_like_flax(A3T(self.vocab_size, self.hp,
                                  self.hp.get("audio_num_mel_bins", 80)))

    def make_loss_fn(self, model: A3T, train: bool = True):
        """``loss_fn(batch, generator=None)``; ``train`` and ``generator``
        change nothing (no dropout)."""
        mel_spec = self.hp.get("mel_losses", "l1:0.5|ssim:0.5")

        def loss_fn(batch, generator=None):
            tm = batch["time_mel_masks"][..., None].to(batch["mels"].dtype)
            out = model(batch["txt_tokens"], batch["mels"], batch["mel2ph"], tm)
            losses: dict = {}
            target = batch["mels"] * tm
            add_mel_loss(losses, out["mel_out_decoder"] * tm, target, mel_spec, "_coarse")
            add_mel_loss(losses, out["mel_out_postnet"] * tm, target, mel_spec, "_fine")
            return sum(losses.values()), losses

        return loss_fn

    def build_infer_fn(self, model: A3T):
        @torch.inference_mode()
        def infer_fn(batch, generator=None, noise=None):
            tm = batch["time_mel_masks"][..., None].float()
            out = model(batch["txt_tokens"], batch["mels"], batch["mel2ph"], tm)
            out["mel_out"] = out["mel_out_postnet"] * tm + batch["mels"] * (1 - tm)
            return out

        return infer_fn

    def params_from_jax(self, params, hp: Any) -> dict:
        return a3t_params_from_jax(params, hp)
