"""One training step: forward, loss, backward, clip, AdamW, NaN tripwire;
and the validation step.

The counterpart of the JAX package's ``make_train_step``,
``make_accum_train_step`` (``TrainStep.accumulate``) and ``make_eval_step``.
When any gradient is non-finite
the update is skipped whole: the parameters, Adam's moments, Adam's count
and the schedule's count stay as they were, ``nan_grads`` is 1, and the
step counter still advances. The finiteness check reads one scalar back to
the host each step (the JAX step selects on the device instead).

``use_bf16`` is JAX's ``bf16_wrap``: the loss runs the model on bf16 copies
of its float parameters and on the batch with every floating entry cast to
bf16 (``global_step`` too, which the step adds first), and its total is
cast back to float32. The casts' backward returns float32 gradients to the
float32 masters; the gradient norm, clipping, the NaN tripwire, AdamW and
the checkpoints stay float32. Not ``torch.autocast``, whose per-op lists
keep some ops in float32, and no loss scaling: bf16 keeps float32's
exponent range. The eval step is never wrapped, as in JAX.

With a mesh (``parallel/mesh.py``) the batch a rank is given is its rows
of the global batch. The loss runs inside ``data_parallel``, so its terms
are the global batch's on every rank, and injected draws (``t``, ``noise``)
are given for the global batch, each rank taking its rows; the gradients
are summed over the data group in one flat bucket, once an update, before
the norm, the tripwire, clipping and AdamW. Under tensor parallelism
(``specs`` from ``parallel/tp.py``, a model axis of more than one rank)
AdamW holds this model rank's slice of each split parameter and of its
moments, takes that slice of the clipped full gradient, and after each
update the slices are all-gathered back into the full parameters the
modules run with (JAX's ``constrain_params``); ``state_dict`` gathers the
moments, so every rank calls it. ``rows`` tells the step how many rows of
a padded global batch are real (``data_parallel``), so that its draws are
a single process's.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Sequence

import torch
from torch import nn
from torch.func import functional_call

from speech_editing_tpu_torch.parallel.mesh import (Mesh, all_reduce_grads, data_parallel,
                                                    local_rows)
from speech_editing_tpu_torch.parallel.tp import MODEL_AXIS, gather, shard, split_dim
from speech_editing_tpu_torch.training.optim import (all_finite, build_lr_schedule,
                                                     build_optimizer, clip_gradients,
                                                     global_norm, load_adam_state)


def cast_floats(batch: dict, dtype) -> dict:
    """``batch`` with every floating tensor cast to ``dtype``; integer and
    boolean entries as they are (JAX's ``_cast_floats``)."""
    return {k: v.to(dtype) if torch.is_tensor(v) and v.is_floating_point() else v
            for k, v in batch.items()}


class _LossCall(nn.Module):
    """Holds the model as a submodule so that ``functional_call`` can swap
    its parameters for the duration of one call of ``loss_fn``."""

    def __init__(self, model: nn.Module, loss_fn: Callable):
        super().__init__()
        self.model, self.loss_fn = model, loss_fn

    def forward(self, batch, generator, draws):
        return self.loss_fn(batch, generator=generator, **draws)


def bf16_loss(model: nn.Module, loss_fn: Callable) -> Callable:
    """``loss_fn`` run in bf16 against float32 master parameters (JAX's
    ``bf16_wrap``): ``wrapped(batch, generator=None, **draws) -> (total
    float32, losses)``."""
    call = _LossCall(model, loss_fn)

    def wrapped(batch, generator=None, **draws):
        params = {f"model.{name}": p.to(torch.bfloat16) if p.is_floating_point() else p
                  for name, p in model.named_parameters()}
        total, losses = functional_call(call, params,
                                        (cast_floats(batch, torch.bfloat16), generator, draws))
        return total.float(), losses

    return wrapped


class TrainStep:
    """``step(batch, generator=None, t=None, noise=None, **draws) -> metrics``:
    the loss terms, ``total_loss``, the pre-clip ``grad_norm`` and
    ``nan_grads``, as 0-d tensors. ``loss_fn(batch, generator=None, **draws)
    -> (total, losses)`` is the task's loss over ``model``; the draws it
    fixes (``t`` and ``noise`` of a diffusion step, EditSpeech's
    ``teacher_forcing``) are passed on when given. ``hp["use_bf16"]`` runs
    it through :func:`bf16_loss`. ``mesh`` and ``specs``: see the module
    doc."""

    def __init__(self, model: nn.Module, hp: Any, loss_fn: Callable,
                 mesh: Mesh | None = None, specs: dict | None = None):
        self.model, self.hp, self.mesh = model, hp, mesh
        self.loss_fn = bf16_loss(model, loss_fn) if hp.get("use_bf16") else loss_fn
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        self.params = [p for _, p in named]
        tp = mesh is not None and mesh.axis_size(MODEL_AXIS) > 1
        # {index in params: spec} of the parameters split over the model axis
        self.split = {i: specs[n] for i, (n, _) in enumerate(named)
                      if tp and split_dim((specs or {}).get(n, ())) is not None}
        # what AdamW updates: each parameter, or this model rank's slice of it
        self.opt_params = [nn.Parameter(shard(p.detach(), self.split[i], mesh).clone())
                           if i in self.split else p for i, p in enumerate(self.params)]
        self.optimizer = build_optimizer(hp, self.opt_params)
        self.schedule = build_lr_schedule(hp)
        self.step = 0       # calls, skipped ones included (TrainState.step)
        self.updates = 0    # applied updates: Adam's and the schedule's count

    def __call__(self, batch: dict, generator: torch.Generator | None = None,
                 t: torch.Tensor | None = None, noise: torch.Tensor | None = None,
                 rows: int | None = None, **draws) -> dict:
        self._zero_grad()
        with data_parallel(self.mesh, rows):
            metrics = self._backward(batch, generator, dict(draws, t=t, noise=noise))
        return dict(metrics, **self._apply(1))

    def accumulate(self, batches: Iterable[dict], generator: torch.Generator | None = None,
                   draws: Sequence[dict] | None = None,
                   rows: Sequence[int] | None = None) -> dict:
        """One update from the gradients of several microbatches (JAX's
        ``make_accum_train_step`` and its host loop): each microbatch's
        loss, at the same ``global_step``, adds its gradient to the sum,
        drawing from ``generator`` in turn (or taking ``draws[i]``;
        ``rows[i]``: its real rows, see the module doc); the
        update applies the sum over the count, and the NaN tripwire and
        ``grad_norm`` read that mean. The metrics are the last
        microbatch's loss terms and ``total_loss`` with the update's
        ``grad_norm`` and ``nan_grads``."""
        self._zero_grad()
        n = 0
        for i, batch in enumerate(batches):
            with data_parallel(self.mesh, rows[i] if rows else None):
                metrics = self._backward(batch, generator, draws[i] if draws else {})
            n += 1
        return dict(metrics, **self._apply(n))

    def _zero_grad(self) -> None:
        for p in self.params + self.opt_params:
            p.grad = None

    def _backward(self, batch: dict, generator, draws: dict) -> dict:
        """The loss of ``batch`` at this update's ``global_step`` (inside the
        caller's ``data_parallel``), its gradient added into the
        parameters' ``.grad``; its metrics."""
        first = next(iter(batch.values()))
        batch = dict(batch, global_step=torch.tensor(float(self.step), device=first.device))
        draws = {k: local_rows(v, first.shape[0]) for k, v in draws.items() if v is not None}
        total, losses = self.loss_fn(batch, generator=generator, **draws)
        total.backward()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total_loss"] = total.detach()
        return metrics

    def _apply(self, n_micro: int) -> dict:
        """The update from the gradients summed over ``n_micro`` losses:
        their mean, its norm, the tripwire, clipping and AdamW."""
        for p in self.params:   # an unused parameter's gradient is zero
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        all_reduce_grads(grads, self.mesh)
        if n_micro > 1:
            torch._foreach_div_(grads, float(n_micro))
        grad_norm = global_norm(grads)
        finite = all_finite(grads)
        if bool(finite):
            clip_gradients(grads, self.hp)
            for i, spec in self.split.items():
                self.opt_params[i].grad = shard(grads[i], spec, self.mesh).clone()
            for group in self.optimizer.param_groups:
                group["lr"] = self.schedule(self.updates)
            self.optimizer.step()
            self.updates += 1
            self._gather_split()
        self.step += 1
        return {"grad_norm": grad_norm.detach(), "nan_grads": (~finite).float()}

    def _gather_split(self) -> None:
        """The full parameters from every model rank's updated slice."""
        with torch.no_grad():
            for i, spec in self.split.items():
                self.params[i].copy_(gather(self.opt_params[i].detach(), spec, self.mesh))

    def sync_split(self) -> None:
        """This rank's slices (and moments) from the full parameters (and
        moments), after the model or the optimizer's state was loaded."""
        state = self.optimizer.state
        with torch.no_grad():
            for i, spec in self.split.items():
                full, part = self.params[i], self.opt_params[i]
                part.copy_(shard(full.detach(), spec, self.mesh))
                st = state.pop(full, None) or state.get(part)
                if st is None:
                    continue
                for key in ("exp_avg", "exp_avg_sq"):
                    if st[key].shape == full.shape:
                        st[key] = shard(st[key], spec, self.mesh).clone()
                state[part] = st

    def state_dict(self) -> dict:
        """The model, the optimizer (the moments whole under tensor
        parallelism: a collective) and the counts."""
        opt = self.optimizer.state_dict()
        for i, spec in self.split.items():
            st = opt["state"].get(i)
            if st is not None:
                opt["state"][i] = dict(st, **{k: gather(st[k], spec, self.mesh)
                                              for k in ("exp_avg", "exp_avg_sq")})
        return {"model": self.model.state_dict(), "optimizer": opt,
                "step": self.step, "updates": self.updates}

    def load_moments(self, mu: dict, nu: dict, count: int,
                     schedule_count: int | None = None) -> None:
        """Adam's moments (``state_dict``s in the model's names, as a task's
        ``params_from_jax`` maps optax's ``mu`` and ``nu``) and its count,
        which is also the count the schedule reads (``updates``); a JAX
        schedule count that differs from Adam's raises."""
        if schedule_count is not None and schedule_count != count:
            raise ValueError(f"Adam's count {count} != the schedule's count {schedule_count}")
        load_adam_state(self.optimizer, self.model, self.params, mu, nu, count)
        self.updates = count
        self.sync_split()

    def load_state_dict(self, state: dict) -> None:
        """Load a state from any device onto this step's device."""
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step, self.updates = state["step"], state["updates"]
        self.sync_split()


def make_eval_step(loss_fn, mesh: Mesh | None = None):
    """``eval_step(batch, generator=None, **draws) -> metrics``: the loss
    terms and ``total_loss`` of ``loss_fn`` (built with ``train=False``)
    under ``torch.no_grad()``, as 0-d tensors, of the global batch across
    ``mesh``'s data axis. The batch carries no ``global_step``, as in the
    JAX eval step: the losses take their defaults."""

    @torch.no_grad()
    def eval_step(batch: dict, generator: torch.Generator | None = None,
                  rows: int | None = None, **draws) -> dict:
        with data_parallel(mesh, rows):
            total, losses = loss_fn(batch, generator=generator, **draws)
        return dict(losses, total_loss=total)

    return eval_step
