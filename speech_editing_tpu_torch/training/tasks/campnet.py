"""CampNet task: the coarse and fine masked mel losses; the port of the JAX
package's ``training/tasks/campnet.py``.

Under autograd each self-attention of the model (3 in the text encoder, 6
in the coarse decoder) runs kernel K3 with its logsumexp and, in the
backward, kernel K4. ``--infer`` composites ``mel_out_fine`` inside the
mask.
"""

from __future__ import annotations

from typing import Any

import torch

from speech_editing_tpu_torch.models.campnet import CampNet
from speech_editing_tpu_torch.training.losses import add_mel_loss
from speech_editing_tpu_torch.training.tasks.base import BaseTask
from speech_editing_tpu_torch.utils.convert_jax_params import campnet_params_from_jax
from speech_editing_tpu_torch.utils.init import init_like_flax


class CampNetTask(BaseTask):
    array_batch_keys = ("txt_tokens", "mels", "time_mel_masks")

    def build_model(self) -> CampNet:
        return init_like_flax(CampNet(self.vocab_size, self.hp,
                                      self.hp.get("audio_num_mel_bins", 80)))

    def make_loss_fn(self, model: CampNet, train: bool = True):
        """``loss_fn(batch, generator=None)``: the model has no dropout (its
        JAX twin's rates are all 0), so ``train`` and ``generator`` change
        nothing."""
        mel_spec = self.hp.get("mel_losses", "l1:0.5|ssim:0.5")

        def loss_fn(batch, generator=None):
            tm = batch["time_mel_masks"][..., None].to(batch["mels"].dtype)
            out = model(batch["txt_tokens"], batch["mels"], tm)
            losses: dict = {}
            target = batch["mels"] * tm
            add_mel_loss(losses, out["mel_out_coarse"] * tm, target, mel_spec, "_coarse")
            add_mel_loss(losses, out["mel_out_fine"] * tm, target, mel_spec, "_fine")
            return sum(losses.values()), losses

        return loss_fn

    def build_infer_fn(self, model: CampNet):
        @torch.inference_mode()
        def infer_fn(batch, generator=None, noise=None):
            tm = batch["time_mel_masks"][..., None].float()
            out = model(batch["txt_tokens"], batch["mels"], tm)
            out["mel_out"] = out["mel_out_fine"] * tm + batch["mels"] * (1 - tm)
            return out

        return infer_fn

    def params_from_jax(self, params, hp: Any) -> dict:
        return campnet_params_from_jax(params, hp)
