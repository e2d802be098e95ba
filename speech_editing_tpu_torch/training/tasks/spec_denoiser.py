"""FluentSpeech (spec_denoiser) task: the model and the training loss.

Masked-region mel losses (l1 + ssim on ``mel_out * mask`` against
``mels * mask``), the duration losses and the pitch loss, over one
training forward of :class:`GaussianDiffusion`. The model starts from
flax's initializers (``utils/init.py``).
"""

from __future__ import annotations

from typing import Any, Sequence

from speech_editing_tpu_torch.models.spec_denoiser.spec_denoiser import GaussianDiffusion
from speech_editing_tpu_torch.training.tasks.base import BaseTask
from speech_editing_tpu_torch.training.losses import (add_mel_loss, dur_loss,
                                                      pitch_loss, sil_token_mask)
from speech_editing_tpu_torch.utils.convert_jax_params import params_from_jax
from speech_editing_tpu_torch.utils.init import init_like_flax


def build_model(vocab_size: int, hp: Any) -> GaussianDiffusion:
    """The model with flax's initial weights, drawn from torch's global
    generator."""
    return init_like_flax(GaussianDiffusion(vocab_size, hp, hp.get("audio_num_mel_bins", 80)))


def make_loss_fn(model: GaussianDiffusion, hp: Any,
                 sil_token_ids: Sequence[int] = (), train: bool = True):
    """``loss_fn(batch, generator=None, t=None, noise=None) -> (total,
    losses)``. Batch keys: txt_tokens [B,S], mels [B,T,80], mel2ph [B,T],
    f0 [B,T], uv [B,T], time_mel_masks [B,T], optional spk_embed [B,256].
    ``train`` turns predictor dropout on; ``t`` and ``noise`` fix the
    diffusion draw (see ``GaussianDiffusion.forward_train``)."""
    mel_spec = hp.get("mel_losses", "l1:0.5|ssim:0.5")
    use_pitch = hp.get("use_pitch_embed", True)
    sil_ids = tuple(sil_token_ids)

    def loss_fn(batch, generator=None, t=None, noise=None):
        tm = batch["time_mel_masks"][..., None].to(batch["mels"].dtype)
        out = model.forward_train(
            batch["txt_tokens"], tm, batch["mel2ph"], batch.get("spk_embed"),
            batch["mels"], batch["f0"], batch["uv"], t=t, noise=noise,
            generator=generator, train=train)
        losses: dict = {}
        add_mel_loss(losses, out["mel_out"] * tm, batch["mels"] * tm, mel_spec,
                     postfix="_coarse")
        is_sil = sil_token_mask(batch["txt_tokens"], sil_ids)
        dur_loss(losses, out["dur"], batch["mel2ph"], batch["txt_tokens"],
                 is_sil, hp)
        if use_pitch:
            pitch_loss(losses, out["pitch_pred"], batch["f0"], batch["uv"],
                       batch["mel2ph"], hp)
        return sum(losses.values()), losses

    return loss_fn


class SpecDenoiserTask(BaseTask):
    """FluentSpeech diffusion editing."""

    def build_model(self) -> GaussianDiffusion:
        return build_model(self.vocab_size, self.hp)

    def make_loss_fn(self, model: GaussianDiffusion, train: bool = True):
        return make_loss_fn(model, self.hp, self.sil_token_ids, train)

    def params_from_jax(self, params, hp: Any) -> dict:
        return params_from_jax(params, hp)
