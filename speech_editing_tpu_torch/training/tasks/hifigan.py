"""HiFi-GAN vocoder training: the generator against the multi-period and
multi-scale discriminators, the port of the JAX package's
``training/tasks/hifigan.py``.

A step (:class:`GanTrainStep`, JAX's ``make_gan_train_step``) runs the
generator once on the batch's mels and then, in this order:

1. the generator's loss: the L1 of the GAN-loss mels times ``lambda_mel``,
   the LSGAN losses of both discriminators on the fake wav (``a_p``,
   ``a_s``, times ``lambda_adv``), with ``use_fm_loss`` the feature
   matching of both (``fm_f``, ``fm_s``), with ``use_ms_stft`` the
   multi-resolution STFT losses (``sc``, ``mag``);
2. the generator's AdamW update, from the gradient with respect to the
   generator alone (the discriminators' parameters get none of it);
3. the discriminators' LSGAN losses (``r_p``, ``f_p``, ``r_s``, ``f_s``) on
   the same fake wav, detached, and their AdamW update.

Both optimizers step every step (no NaN tripwire, no clipping, no
accumulation); ``total_loss`` is the sum of the two totals. With a mesh
(``parallel/mesh.py``) the batch is this rank's rows of the global batch,
both losses are the global batch's (``data_parallel``) and each net's
gradients are summed over the data group before its update, as JAX's step
over a batch-sharded input computes them; the nets stay whole on every
rank. The eval step
is the unscaled mel L1, as ``mel`` and ``total_loss``; the test loop is
copy synthesis. The GAN-loss mel and the STFT losses are library products,
and the convolutions cuDNN's: this task runs no kernel of the port's.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from speech_editing_tpu_torch.data.vocoder_dataset import VocoderDataset
from speech_editing_tpu_torch.models.vocoder.hifigan import (HifiGanGenerator,
                                                             MultiPeriodDiscriminator,
                                                             MultiScaleDiscriminator,
                                                             discriminator_loss, feature_loss,
                                                             generator_loss)
from speech_editing_tpu_torch.models.vocoder.losses import (gan_mel_spectrogram,
                                                            multi_resolution_stft_loss)
from speech_editing_tpu_torch.parallel.mesh import (Mesh, all_reduce_grads, data_parallel,
                                                    global_mean)
from speech_editing_tpu_torch.training.optim import (build_gan_lr_schedule,
                                                     build_gan_optimizer, load_adam_state)
from speech_editing_tpu_torch.training.tasks.base import BaseTask
from speech_editing_tpu_torch.utils.convert_jax_params import (discriminator_params_from_jax,
                                                               vocoder_params_from_jax)
from speech_editing_tpu_torch.utils.init import init_like_flax


class HifiGanDiscriminators(nn.Module):
    """The MPD (``hp["disc_periods"]``, default 2, 3, 5, 7, 11) and the MSD
    (``hp["msd_scales"]``, default 3). ``forward(y, y_hat)`` -> the MPD's
    and the MSD's (real scores, fake scores, real maps, fake maps)."""

    def __init__(self, hp: Any):
        super().__init__()
        self.mpd = MultiPeriodDiscriminator(tuple(hp.get("disc_periods", (2, 3, 5, 7, 11))))
        self.msd = MultiScaleDiscriminator(int(hp.get("msd_scales", 3)))

    def forward(self, y, y_hat):
        return self.mpd(y, y_hat), self.msd(y, y_hat)


def mel_l1(y: torch.Tensor, y_hat: torch.Tensor, hp: Any) -> torch.Tensor:
    """Mean |GAN mel(y_hat) - GAN mel(y)|."""
    return global_mean(torch.abs(gan_mel_spectrogram(y_hat, hp) - gan_mel_spectrogram(y, hp)))


class TwoNetState:
    """The state of a step that updates a generator (``model``,
    ``gen_opt`` over ``gen_params``) and its discriminators (``disc``,
    ``disc_opt`` over ``disc_params``), ``step`` counting the steps: its
    checkpoint form and a JAX ``GanTrainState``'s."""

    def state_dict(self) -> dict:
        """The generator under ``model`` (where the vocoder reads it), the
        discriminators, both optimizers and the step."""
        return {"model": self.model.state_dict(), "disc": self.disc.state_dict(),
                "gen_opt": self.gen_opt.state_dict(), "disc_opt": self.disc_opt.state_dict(),
                "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        """Load a state from any device onto this step's device."""
        self.model.load_state_dict(state["model"])
        self.disc.load_state_dict(state["disc"])
        self.gen_opt.load_state_dict(state["gen_opt"])
        self.disc_opt.load_state_dict(state["disc_opt"])
        self.step = state["step"]

    def load_jax(self, gen: dict, disc: dict, gen_adam: dict, disc_adam: dict,
                 steps: int) -> None:
        """A JAX ``GanTrainState`` converted to ``state_dict``s: both nets,
        both Adam states (``{"mu", "nu", "count"}`` in the nets' names)."""
        self.model.load_state_dict(gen)
        self.disc.load_state_dict(disc)
        for opt, net, params, adam in ((self.gen_opt, self.model, self.gen_params, gen_adam),
                                       (self.disc_opt, self.disc, self.disc_params, disc_adam)):
            load_adam_state(opt, net, params, adam["mu"], adam["nu"], adam["count"])
        self.step = steps


class GanTrainStep(TwoNetState):
    """``step(batch, generator=None, rows=None) -> metrics`` (0-d tensors)
    over the batch's ``mels`` [B, T, 80] and ``wavs`` [B, T * hop]: one
    generator and one discriminator update (see the module doc; ``rows``,
    the trainer's count of real rows, is unused: the step draws nothing). ``step`` counts the
    steps, which is also both optimizers' and the schedule's count.
    ``mesh``: see the module doc."""

    def __init__(self, model: nn.Module, disc: nn.Module, hp: Any, mesh: Mesh | None = None):
        self.model, self.disc, self.hp, self.mesh = model, disc, hp, mesh
        self.gen_params = [p for p in model.parameters() if p.requires_grad]
        self.disc_params = [p for p in disc.parameters() if p.requires_grad]
        self.gen_opt = build_gan_optimizer(hp, self.gen_params)
        self.disc_opt = build_gan_optimizer(hp, self.disc_params)
        self.schedule = build_gan_lr_schedule(hp)
        self.lambda_mel = float(hp.get("lambda_mel", 45.0))
        self.lambda_adv = float(hp.get("lambda_adv", 1.0))
        self.use_fm = bool(hp.get("use_fm_loss", True))
        self.use_ms_stft = bool(hp.get("use_ms_stft", False))
        self.step = 0

    def generator_losses(self, y, y_) -> dict:
        losses = {"mel": mel_l1(y, y_, self.hp) * self.lambda_mel}
        (_, p_g, fp_r, fp_g), (_, s_g, fs_r, fs_g) = self.disc(y, y_)
        losses["a_p"] = generator_loss(p_g) * self.lambda_adv
        losses["a_s"] = generator_loss(s_g) * self.lambda_adv
        if self.use_fm:
            losses["fm_f"] = feature_loss(fp_r, fp_g)
            losses["fm_s"] = feature_loss(fs_r, fs_g)
        if self.use_ms_stft:
            losses["sc"], losses["mag"] = multi_resolution_stft_loss(y_, y)
        return losses

    def discriminator_losses(self, y, y_detached) -> dict:
        (p_r, p_g, _, _), (s_r, s_g, _, _) = self.disc(y, y_detached)
        losses = {}
        losses["r_p"], losses["f_p"] = discriminator_loss(p_r, p_g)
        losses["r_s"], losses["f_s"] = discriminator_loss(s_r, s_g)
        return losses

    def _update(self, optimizer, params, total) -> None:
        grads = torch.autograd.grad(total, params)
        all_reduce_grads(grads, self.mesh)
        for p, g in zip(params, grads):
            p.grad = g
        for group in optimizer.param_groups:
            group["lr"] = self.schedule(self.step)
        optimizer.step()

    def __call__(self, batch: dict, generator: torch.Generator | None = None,
                 rows: int | None = None) -> dict:
        y = batch["wavs"]
        y_ = self.model(batch["mels"])
        with data_parallel(self.mesh):
            g_losses = self.generator_losses(y, y_)
        g_total = sum(g_losses.values())
        self._update(self.gen_opt, self.gen_params, g_total)
        with data_parallel(self.mesh):
            d_losses = self.discriminator_losses(y, y_.detach())
        d_total = sum(d_losses.values())
        self._update(self.disc_opt, self.disc_params, d_total)
        self.step += 1
        metrics = {k: v.detach() for k, v in {**g_losses, **d_losses}.items()}
        metrics["total_loss"] = (g_total + d_total).detach()
        return metrics



class HifiGanTask(BaseTask):
    """HiFi-GAN V1 (or any generator the hp's widths give) on a vocoder
    corpus: mel + wav items, ``max_samples`` a crop."""

    dataset_cls = VocoderDataset
    array_batch_keys = ("mels", "wavs")
    is_gan = True

    def build_model(self) -> HifiGanGenerator:
        return init_like_flax(HifiGanGenerator(self.hp))

    def build_discriminators(self) -> HifiGanDiscriminators:
        return init_like_flax(HifiGanDiscriminators(self.hp))

    def make_gan_train_step(self, model, disc, mesh: Mesh | None = None) -> GanTrainStep:
        return GanTrainStep(model, disc, self.hp, mesh)

    def make_gan_eval_step(self, model, mesh: Mesh | None = None):
        """``eval_step(batch, generator=None) -> {"mel", "total_loss"}``:
        the unscaled mel L1 of the generator's wav, over the global batch
        across ``mesh``'s data axis."""
        hp = self.hp

        @torch.no_grad()
        def eval_step(batch: dict, generator: torch.Generator | None = None,
                      rows: int | None = None) -> dict:
            wav = model(batch["mels"])
            with data_parallel(mesh):
                loss = mel_l1(batch["wavs"], wav, hp)
            return {"mel": loss, "total_loss": loss}

        return eval_step

    def params_from_jax(self, params, hp: Any) -> dict:
        return vocoder_params_from_jax(params, hp)

    def disc_params_from_jax(self, params, hp: Any) -> dict:
        return discriminator_params_from_jax(params, hp)

    def build_infer_fn(self, model):
        """Copy synthesis: ``infer_fn(batch) -> {"mel_out": mels, "wav_out"
        [B, T * hop]}``."""

        @torch.inference_mode()
        def infer_fn(batch, generator=None, noise=None):
            return {"mel_out": batch["mels"], "wav_out": model(batch["mels"])}

        return infer_fn
