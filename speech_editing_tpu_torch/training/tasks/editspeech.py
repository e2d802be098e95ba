"""EditSpeech task: the forward and backward decoders' masked mel losses
and the duration loss; the port of the JAX package's
``training/tasks/editspeech.py``.

Each step draws one teacher-forcing coin for the batch (p = 0.5) from the
trainer's ``torch.Generator``; ``loss_fn(..., teacher_forcing=x)`` fixes
it. The decoders' LSTMs run on cuDNN on the card. ``--infer`` splices the
two directions with ``bidirectional_fusion``.
"""

from __future__ import annotations

from typing import Any

import torch

from speech_editing_tpu_torch.models.editspeech import EditSpeech, bidirectional_fusion
from speech_editing_tpu_torch.training.losses import add_mel_loss, dur_loss, sil_token_mask
from speech_editing_tpu_torch.training.tasks.base import BaseTask
from speech_editing_tpu_torch.utils.convert_jax_params import editspeech_params_from_jax
from speech_editing_tpu_torch.utils.init import init_like_flax


class EditSpeechTask(BaseTask):
    def build_model(self) -> EditSpeech:
        return init_like_flax(EditSpeech(self.vocab_size, self.hp,
                                         self.hp.get("audio_num_mel_bins", 80)))

    def make_loss_fn(self, model: EditSpeech, train: bool = True):
        """``loss_fn(batch, generator=None, teacher_forcing=None)``;
        ``train`` turns predictor dropout on."""
        hp = self.hp
        mel_spec = hp.get("mel_losses", "l1:0.5|ssim:0.5")
        sil_ids = self.sil_token_ids

        def loss_fn(batch, generator=None, teacher_forcing=None):
            tm = batch["time_mel_masks"][..., None].to(batch["mels"].dtype)
            out = model.forward_train(
                batch["txt_tokens"], tm, batch["mel2ph"], batch.get("spk_embed"),
                batch["mels"], batch["f0"], batch["uv"], train=train, generator=generator,
                teacher_forcing=teacher_forcing)
            losses: dict = {}
            target = batch["mels"] * tm
            add_mel_loss(losses, out["forward_outputs"] * tm, target, mel_spec, "_forward")
            add_mel_loss(losses, out["backward_outputs"] * tm, target, mel_spec, "_backward")
            is_sil = sil_token_mask(batch["txt_tokens"], sil_ids)
            dur_loss(losses, out["dur"], batch["mel2ph"], batch["txt_tokens"], is_sil, hp)
            return sum(losses.values()), losses

        return loss_fn

    def build_infer_fn(self, model: EditSpeech):
        @torch.inference_mode()
        def infer_fn(batch, generator=None, noise=None):
            tm = batch["time_mel_masks"][..., None].float()
            out = model(batch["txt_tokens"], tm, batch["mel2ph"], batch.get("spk_embed"),
                        batch["mels"], batch["f0"], batch["uv"])
            out["mel_out"] = bidirectional_fusion(out["forward_outputs"],
                                                  out["backward_outputs"], batch["mels"], tm)
            return out

        return infer_fn

    def params_from_jax(self, params, hp: Any) -> dict:
        return editspeech_params_from_jax(params, hp)
