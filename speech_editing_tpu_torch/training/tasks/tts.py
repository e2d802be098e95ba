"""The TTS baselines' tasks: FastSpeech, FastSpeech2-orig and DiffSpeech;
the port of the JAX package's ``training/tasks/tts.py``.

FastSpeech: mel L1 and SSIM on the whole target, the duration losses and
the frame pitch loss. FastSpeech2-orig adds the energy L1 (against the
frame energy of the target mel) and, under ``pitch_type: cwt``, the CWT
branch's losses in place of the frame pitch loss: L1 on the 10 scales, uv
BCE over the frames, L1 on the log-f0 mean and std (the dataset serves
``cwt_spec``, ``f0_mean`` and ``f0_std``). DiffSpeech: the masked epsilon
L1 with the duration and pitch losses. The datasets are the editing
corpus's (its masks are not read). ``--infer`` and the validation media run
each task's ``build_infer_fn``: the dataset's durations and pitch, and for
DiffSpeech the whole reverse process.

On the card the FFT encoder's self-attention is K3 (K4 in the backward),
as is FastSpeech's FFT decoder's over mel frames; DiffSpeech's DiffNet is
K1 unmasked (K5 in the backward).
"""

from __future__ import annotations

from typing import Any

import torch

from speech_editing_tpu_torch.models.diffspeech import DiffSpeech
from speech_editing_tpu_torch.models.fs import FastSpeech
from speech_editing_tpu_torch.models.fs2_orig import FastSpeech2Orig
from speech_editing_tpu_torch.parallel.mesh import global_mean
from speech_editing_tpu_torch.training.losses import (_weighted_mean, add_mel_loss,
                                                      dur_loss, pitch_loss, ratio,
                                                      sigmoid_bce, sil_token_mask)
from speech_editing_tpu_torch.training.tasks.base import BaseTask
from speech_editing_tpu_torch.utils.convert_jax_params import (diffspeech_params_from_jax,
                                                               fastspeech_params_from_jax,
                                                               fs2_orig_params_from_jax)
from speech_editing_tpu_torch.utils.init import init_like_flax


def mel_energy(mels: torch.Tensor) -> torch.Tensor:
    """Frame energy [B, T] of a log10 mel [B, T, M]."""
    return torch.sqrt(((10.0 ** mels) ** 2).sum(-1) + 1e-8)


class FastSpeechTask(BaseTask):
    array_batch_keys = ("txt_tokens", "mels", "mel2ph", "f0", "uv")

    def build_model(self):
        return init_like_flax(FastSpeech(self.vocab_size, self.hp, decoder=True, masked=False))

    def forward(self, model, batch: dict, train: bool, generator=None, **draws) -> dict:
        """The training forward on a device batch."""
        return model(batch["txt_tokens"], None, batch["mel2ph"], batch.get("spk_embed"),
                     batch["f0"], batch["uv"], train=train, generator=generator)

    def add_losses(self, losses: dict, out: dict, batch: dict) -> None:
        """The mel losses (:meth:`make_loss_fn` adds the duration, pitch
        and energy losses after them, in JAX's order)."""
        add_mel_loss(losses, out["mel_out"], batch["mels"],
                     self.hp.get("mel_losses", "l1:0.5|ssim:0.5"))

    def add_pitch_losses(self, losses: dict, out: dict, batch: dict) -> None:
        if self.hp.get("use_pitch_embed", True):
            pitch_loss(losses, out["pitch_pred"], batch["f0"], batch["uv"], batch["mel2ph"],
                       self.hp)

    def make_loss_fn(self, model, train: bool = True):
        """``loss_fn(batch, generator=None, **draws) -> (total, losses)``;
        ``train`` turns dropout on, its masks from ``generator``."""
        hp, sil_ids = self.hp, self.sil_token_ids

        def loss_fn(batch, generator=None, **draws):
            out = self.forward(model, batch, train, generator, **draws)
            losses: dict = {}
            self.add_losses(losses, out, batch)
            dur_loss(losses, out["dur"], batch["mel2ph"], batch["txt_tokens"],
                     sil_token_mask(batch["txt_tokens"], sil_ids), hp)
            self.add_pitch_losses(losses, out, batch)
            self.add_energy_loss(losses, out, batch)
            return sum(losses.values()), losses

        return loss_fn

    def add_energy_loss(self, losses: dict, out: dict, batch: dict) -> None:
        """None but FastSpeech2-orig's."""

    def build_infer_fn(self, model):
        """``infer_fn(batch, generator=None, noise=None) -> out``: the
        model's ``mel_out`` with the dataset's durations and pitch."""

        @torch.inference_mode()
        def infer_fn(batch, generator=None, noise=None):
            return model(batch["txt_tokens"], None, batch["mel2ph"], batch.get("spk_embed"),
                         batch["f0"], batch["uv"])

        return infer_fn

    def params_from_jax(self, params, hp: Any) -> dict:
        return fastspeech_params_from_jax(params, hp)


class FastSpeech2OrigTask(FastSpeechTask):
    def build_model(self):
        return init_like_flax(FastSpeech2Orig(self.vocab_size, self.hp))

    @property
    def cwt(self) -> bool:
        return self.hp.get("pitch_type") == "cwt" and self.hp.get("use_pitch_embed", True)

    def effective_batch_keys(self) -> tuple:
        keys = super().effective_batch_keys()
        return keys + ("cwt_spec", "f0_mean", "f0_std") if self.cwt else keys

    def forward(self, model, batch, train, generator=None, **draws):
        energy = mel_energy(batch["mels"]) if self.hp.get("use_energy_embed") else None
        out = model(batch["txt_tokens"], batch["mel2ph"], batch.get("spk_embed"),
                    batch["f0"], batch["uv"], energy, train=train, generator=generator)
        out["energy_gt"] = energy
        return out

    def add_pitch_losses(self, losses, out, batch):
        hp = self.hp
        if not self.cwt:
            super().add_pitch_losses(losses, out, batch)
            return
        lam_f0 = hp.get("lambda_f0", 1.0)
        t = out["cwt"].shape[1]
        cwt_gt = batch["cwt_spec"][:, :t]
        losses["C"] = global_mean((out["cwt"][:, :cwt_gt.shape[1], :10] - cwt_gt).abs()) * lam_f0
        if hp.get("use_uv", True):
            nonpadding = (batch["mel2ph"] != 0).float()
            uv_logit = out["cwt"][:, :, -1][:, :nonpadding.shape[1]]
            bce = sigmoid_bce(uv_logit, batch["uv"][:, :uv_logit.shape[1]])
            losses["uv"] = (_weighted_mean(bce, nonpadding[:, :uv_logit.shape[1]])
                            * hp.get("lambda_uv", 1.0))
        losses["f0_mean"] = global_mean((out["f0_mean"] - batch["f0_mean"]).abs()) * lam_f0
        losses["f0_std"] = global_mean((out["f0_std"] - batch["f0_std"]).abs()) * lam_f0

    def add_energy_loss(self, losses, out, batch):
        if self.hp.get("use_energy_embed"):
            e_l1 = (out["energy_pred"] - out["energy_gt"]).abs()
            losses["e"] = (_weighted_mean(e_l1, (batch["mel2ph"] != 0).float())
                           * self.hp.get("lambda_energy", 0.1))

    def build_infer_fn(self, model):
        """Durations and energy predicted (``infer``), the dataset's f0."""

        @torch.inference_mode()
        def infer_fn(batch, generator=None, noise=None):
            return model(batch["txt_tokens"], batch["mel2ph"], batch.get("spk_embed"),
                         batch["f0"], batch["uv"], infer=True)

        return infer_fn

    def params_from_jax(self, params, hp: Any) -> dict:
        return fs2_orig_params_from_jax(params, hp)


class DiffSpeechTask(FastSpeechTask):
    def build_model(self):
        return init_like_flax(DiffSpeech(self.vocab_size, self.hp,
                                         self.hp.get("audio_num_mel_bins", 80)))

    def forward(self, model, batch, train, generator=None, t=None, noise=None):
        return model.forward_train(batch["txt_tokens"], batch["mel2ph"], batch.get("spk_embed"),
                                   batch["mels"], batch["f0"], batch["uv"], t=t, noise=noise,
                                   generator=generator, train=train)

    def add_losses(self, losses, out, batch):
        """The epsilon L1 over the frames of ``mel2ph``."""
        nonpadding = (batch["mel2ph"] != 0).float()[:, :, None]
        diff = (out["noise_pred"] - out["noise_gt"]).abs()
        losses["diff"] = ratio((diff * nonpadding).sum(), nonpadding.sum() * diff.shape[-1])

    def build_infer_fn(self, model):
        """The reverse process from the dataset's durations and pitch, its
        state unmasked between steps as JAX's ``p_sample_loop`` runs it;
        ``noise`` as in ``DiffSpeech.forward``."""

        @torch.inference_mode()
        def infer_fn(batch, generator=None, noise=None):
            return model(batch["txt_tokens"], batch["mel2ph"], batch.get("spk_embed"),
                         batch["f0"], batch["uv"], generator=generator, noise=noise,
                         mask_steps=False)

        return infer_fn

    def params_from_jax(self, params, hp: Any) -> dict:
        return diffspeech_params_from_jax(params, hp)
