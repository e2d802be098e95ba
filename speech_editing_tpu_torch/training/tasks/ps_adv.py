"""Adversarial PortaSpeech: PortaSpeech against the multi-window mel
discriminator; the port of the JAX package's ``training/tasks/ps_adv.py``.

A step (:class:`AdvTrainStep`, JAX's ``make_gan_train_step`` of this task)
runs, in this order:

1. the generator's loss: the mel losses, the KL floored at ``kl_min`` times
   ``lambda_kl`` (no warm-up: the GAN step puts no step count in the batch,
   so ``posterior_start_steps`` never applies either), the word-duration
   loss (not scaled), and the LSGAN loss of the discriminator on the
   generated mel at windows it draws (``adv``, times ``lambda_mel_adv``
   when ``disc_start_steps`` is 0, else 0);
2. the generator's update: AdamW from ``build_optimizer`` (clipping,
   ``lr`` on the ``warmup`` schedule) on the gradient with respect to the
   generator alone;
3. the discriminator's LSGAN losses on the ground-truth and the generated
   mel from before the update, detached, at the same windows, and its own
   AdamW at ``disc_lr``.

``total_loss`` is the sum of both totals. With a mesh (``parallel/``) the
batch is this rank's rows of the global batch, every loss is the global
batch's (``data_parallel``), the draws (the posterior's noise, dropout, the
window starts) are the global batch's, and each net's gradients are summed
over the data group before its update, as JAX's step over a batch-sharded
input computes them. The eval step is PortaSpeech's loss.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from speech_editing_tpu_torch.modules.multi_window_disc import MultiWindowDiscriminator
from speech_editing_tpu_torch.parallel.mesh import (Mesh, all_reduce_grads, data_parallel,
                                                    global_mean)
from speech_editing_tpu_torch.training.optim import (build_lr_schedule, build_optimizer,
                                                     clip_gradients)
from speech_editing_tpu_torch.training.tasks.hifigan import TwoNetState
from speech_editing_tpu_torch.training.tasks.portaspeech import PortaSpeechTask, word_dur_loss
from speech_editing_tpu_torch.training.train_state import make_eval_step
from speech_editing_tpu_torch.utils.convert_jax_params import multi_window_disc_params_from_jax
from speech_editing_tpu_torch.utils.init import init_like_flax


class AdvTrainStep(TwoNetState):
    """``step(batch, generator=None, rows=None, eps=None,
    start_frames=None) -> metrics`` (0-d tensors): one generator and one
    discriminator update (see the module doc). ``eps`` (the posterior's
    noise) and ``start_frames`` (the windows' starts) are drawn from
    ``generator`` when None; ``rows``: the real rows of a padded global
    batch. ``step`` counts the steps, which is also both optimizers' and
    both schedules' count; checkpoints and JAX states: ``TwoNetState``."""

    def __init__(self, task: PortaSpeechTask, model: nn.Module, disc: nn.Module, hp: Any,
                 mesh: Mesh | None = None):
        self.task, self.model, self.disc, self.hp, self.mesh = task, model, disc, hp, mesh
        self.disc_hp = dict(hp, lr=hp.get("disc_lr", hp["lr"]))
        self.gen_params = [p for p in model.parameters() if p.requires_grad]
        self.disc_params = [p for p in disc.parameters() if p.requires_grad]
        self.gen_opt = build_optimizer(hp, self.gen_params)
        self.disc_opt = build_optimizer(self.disc_hp, self.disc_params)
        self.gen_schedule = build_lr_schedule(hp)
        self.disc_schedule = build_lr_schedule(self.disc_hp)
        self.lambda_adv = (float(hp.get("lambda_mel_adv", 0.05))
                           if int(hp.get("disc_start_steps", 0)) == 0 else 0.0)
        self.step = 0

    def generator_losses(self, batch: dict, generator, eps, start_frames):
        """(losses, the generated mel, x_len, the windows' starts)."""
        hp = self.hp
        out = self.task.forward(self.model, batch, True, generator, eps=eps)
        losses: dict = {}
        self.task.add_losses(losses, out, batch)
        losses["kl"] = out["kl"].clamp(min=hp.get("kl_min", 0.0)) * hp.get("lambda_kl", 1.0)
        losses["wdur"] = word_dur_loss(out["dur"], batch["mel2word"], batch["word_tokens"])
        mel = out["mel_out"]
        x_len = (batch["mel2word"][:, :mel.shape[1]] > 0).sum(-1)
        d_fake = self.disc(mel, x_len, generator, start_frames)
        losses["adv"] = global_mean((d_fake["y"] - 1.0) ** 2) * self.lambda_adv
        return losses, mel, x_len, d_fake["start_frames"]

    def discriminator_losses(self, mels, mel_fake, x_len, starts) -> dict:
        d_real = self.disc(mels, x_len, start_frames=starts)
        d_fake = self.disc(mel_fake, x_len, start_frames=starts)
        return {"disc_real": global_mean((d_real["y"] - 1.0) ** 2),
                "disc_fake": global_mean(d_fake["y"] ** 2)}

    def _update(self, optimizer, params, total, hp, schedule) -> None:
        grads = torch.autograd.grad(total, params)
        all_reduce_grads(grads, self.mesh)
        clip_gradients(grads, hp)
        for p, g in zip(params, grads):
            p.grad = g
        for group in optimizer.param_groups:
            group["lr"] = schedule(self.step)
        optimizer.step()

    def __call__(self, batch: dict, generator: torch.Generator | None = None,
                 rows: int | None = None, eps=None, start_frames=None) -> dict:
        with data_parallel(self.mesh, rows):
            g_losses, mel, x_len, starts = self.generator_losses(batch, generator, eps,
                                                                 start_frames)
        g_total = sum(g_losses.values())
        self._update(self.gen_opt, self.gen_params, g_total, self.hp, self.gen_schedule)
        with data_parallel(self.mesh, rows):
            d_losses = self.discriminator_losses(batch["mels"][:, :mel.shape[1]], mel.detach(),
                                                 x_len, starts)
        d_total = sum(d_losses.values())
        self._update(self.disc_opt, self.disc_params, d_total, self.disc_hp, self.disc_schedule)
        self.step += 1
        metrics = {k: v.detach() for k, v in {**g_losses, **d_losses}.items()}
        metrics["total_loss"] = (g_total + d_total).detach()
        return metrics


class PortaSpeechAdvTask(PortaSpeechTask):
    is_gan = True

    def build_discriminators(self) -> MultiWindowDiscriminator:
        hp = self.hp
        return init_like_flax(MultiWindowDiscriminator(
            (32, 64, 128)[:int(hp.get("disc_win_num", 3))], hp.get("audio_num_mel_bins", 80),
            hidden_size=hp.get("mel_disc_hidden_size", 128)))

    def make_gan_train_step(self, model, disc, mesh: Mesh | None = None) -> AdvTrainStep:
        return AdvTrainStep(self, model, disc, self.hp, mesh)

    def make_gan_eval_step(self, model, mesh: Mesh | None = None):
        """PortaSpeech's loss (no dropout, the KL at full weight)."""
        return make_eval_step(self.make_loss_fn(model, train=False), mesh)

    def disc_params_from_jax(self, params, hp: Any) -> dict:
        return multi_window_disc_params_from_jax(params)
