"""Learning-rate schedules, AdamW and gradient clipping, with optax's
semantics (the JAX package's ``training/optim.py``):

* schedules ``none`` / ``warmup`` (linear ramp to ``lr`` over
  ``warmup_updates``) / ``rsqrt``, evaluated at the number of updates
  already applied, so under ``warmup`` the first update has lr 0;
* clipping by value, then by global norm with optax's ``max_norm / norm``
  scale (no epsilon, unlike ``torch.nn.utils.clip_grad_norm_``);
* AdamW(beta1, beta2, eps 1e-8, weight_decay), whose update equals optax's;
* HiFi-GAN's pair of AdamW with a step-decay schedule (``build_gan_optimizer``).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def build_lr_schedule(hp) -> Callable[[int], float]:
    kind = hp.get("scheduler", "warmup")
    lr = float(hp["lr"])
    warmup = int(hp.get("warmup_updates", 8000))
    if kind in ("none", None, ""):
        return lambda step: lr
    if kind == "warmup":
        return lambda step: lr * min(step / max(warmup, 1), 1.0)
    if kind == "rsqrt":
        factor = float(hp.get("hidden_size", 256)) ** -0.5

        def sched(step):
            step = max(step, 1.0)
            return lr * factor * min(step * warmup ** -1.5, step ** -0.5) * warmup ** 0.5
        return sched
    raise NotImplementedError(f"scheduler={kind}")


def build_optimizer(hp, params) -> torch.optim.AdamW:
    """AdamW over ``params``; the caller sets each step's lr from the
    schedule."""
    return torch.optim.AdamW(
        params, lr=0.0,
        betas=(float(hp.get("optimizer_adam_beta1", 0.9)),
               float(hp.get("optimizer_adam_beta2", 0.98))),
        eps=1e-8, weight_decay=float(hp.get("weight_decay", 0) or 0.0))


def build_gan_lr_schedule(hp) -> Callable[[int], float]:
    """HiFi-GAN's step decay: ``lr * lr_decay ** floor(count /
    scheduler_step_size)`` at the updates already applied."""
    lr = float(hp["lr"])
    gamma = float(hp.get("lr_decay", 0.999))
    decay_steps = int(hp.get("scheduler_step_size", 600))
    return lambda step: lr * gamma ** (step // decay_steps)


def build_gan_optimizer(hp, params) -> torch.optim.AdamW:
    """One of HiFi-GAN's two AdamW (``adam_b1``, ``adam_b2``, eps 1e-8 and
    optax's default weight decay 1e-4, not torch's 1e-2), no clipping; the
    caller sets each step's lr from :func:`build_gan_lr_schedule`."""
    return torch.optim.AdamW(
        params, lr=0.0, betas=(float(hp.get("adam_b1", 0.8)), float(hp.get("adam_b2", 0.99))),
        eps=1e-8, weight_decay=1e-4)


def load_adam_state(optimizer: torch.optim.Optimizer, model: torch.nn.Module,
                    params: Sequence[torch.Tensor], mu: dict, nu: dict, count: int) -> None:
    """Adam's moments of ``params`` (``state_dict``s in ``model``'s names,
    as a converter maps optax's ``mu`` and ``nu``) and its count, into
    ``optimizer``'s state."""
    names = {p: name for name, p in model.named_parameters()}
    for p in params:
        optimizer.state[p] = {"step": torch.tensor(float(count)),
                              "exp_avg": mu[names[p]].to(p.device, p.dtype).clone(),
                              "exp_avg_sq": nu[names[p]].to(p.device, p.dtype).clone()}


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, a 0-d tensor."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


def all_finite(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """0-d bool: every element is finite (max-abs per tensor, which cannot
    overflow the way a sum of squares can)."""
    return torch.isfinite(torch.stack(
        torch._foreach_norm(list(tensors), float("inf")))).all()


def clip_gradients(grads: Sequence[torch.Tensor], hp) -> None:
    """In place: ``clip_grad_value`` then ``clip_grad_norm``, as the optax
    chain of ``build_optimizer`` applies them."""
    grads = list(grads)
    if hp.get("clip_grad_value", 0):
        v = float(hp["clip_grad_value"])
        for g in grads:
            g.clamp_(-v, v)
    if hp.get("clip_grad_norm", 0):
        max_norm = float(hp["clip_grad_norm"])
        norm = global_norm(grads)
        scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
        torch._foreach_mul_(grads, scale)
