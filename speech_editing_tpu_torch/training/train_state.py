"""One training step: forward, loss, backward, clip, AdamW, NaN tripwire;
and the validation step.

The counterpart of the JAX package's ``make_train_step`` and
``make_eval_step`` without a mesh or bf16. When any gradient is non-finite
the update is skipped whole: the parameters, Adam's moments, Adam's count
and the schedule's count stay as they were, ``nan_grads`` is 1, and the
step counter still advances. The finiteness check reads one scalar back to
the host each step (the JAX step selects on the device instead).
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch import nn

from speech_editing_tpu_torch.training.optim import (all_finite, build_lr_schedule,
                                                     build_optimizer,
                                                     clip_gradients, global_norm)


class TrainStep:
    """``step(batch, generator=None, t=None, noise=None, **draws) -> metrics``:
    the loss terms, ``total_loss``, the pre-clip ``grad_norm`` and
    ``nan_grads``, as 0-d tensors. ``loss_fn(batch, generator=None, **draws)
    -> (total, losses)`` is the task's loss over ``model``; the draws it
    fixes (``t`` and ``noise`` of a diffusion step, EditSpeech's
    ``teacher_forcing``) are passed on when given."""

    def __init__(self, model: nn.Module, hp: Any, loss_fn: Callable):
        self.model, self.hp = model, hp
        self.loss_fn = loss_fn
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.optimizer = build_optimizer(hp, self.params)
        self.schedule = build_lr_schedule(hp)
        self.step = 0       # calls, skipped ones included (TrainState.step)
        self.updates = 0    # applied updates: Adam's and the schedule's count

    def __call__(self, batch: dict, generator: torch.Generator | None = None,
                 t: torch.Tensor | None = None, noise: torch.Tensor | None = None,
                 **draws) -> dict:
        self.optimizer.zero_grad(set_to_none=True)
        draws = {k: v for k, v in dict(draws, t=t, noise=noise).items() if v is not None}
        device = next(iter(batch.values())).device
        batch = dict(batch, global_step=torch.tensor(float(self.step), device=device))
        total, losses = self.loss_fn(batch, generator=generator, **draws)
        total.backward()
        for p in self.params:   # an unused parameter's gradient is zero
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        grad_norm = global_norm(grads)
        finite = all_finite(grads)
        if bool(finite):
            clip_gradients(grads, self.hp)
            for group in self.optimizer.param_groups:
                group["lr"] = self.schedule(self.updates)
            self.optimizer.step()
            self.updates += 1
        self.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics.update(total_loss=total.detach(), grad_norm=grad_norm.detach(),
                       nan_grads=(~finite).float())
        return metrics

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "step": self.step, "updates": self.updates}

    def load_state_dict(self, state: dict) -> None:
        """Load a state from any device onto this step's device."""
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step, self.updates = state["step"], state["updates"]


def make_eval_step(loss_fn):
    """``eval_step(batch, generator=None, **draws) -> metrics``: the loss
    terms and ``total_loss`` of ``loss_fn`` (built with ``train=False``)
    under ``torch.no_grad()``, as 0-d tensors. The batch carries no
    ``global_step``, as in the JAX eval step: the losses take their
    defaults."""

    @torch.no_grad()
    def eval_step(batch: dict, generator: torch.Generator | None = None, **draws) -> dict:
        total, losses = loss_fn(batch, generator=generator, **draws)
        return dict(losses, total_loss=total)

    return eval_step
