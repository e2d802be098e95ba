"""Learning-rate schedules, AdamW and gradient clipping, with optax's
semantics (the JAX package's ``training/optim.py``):

* schedules ``none`` / ``warmup`` (linear ramp to ``lr`` over
  ``warmup_updates``) / ``rsqrt``, evaluated at the number of updates
  already applied, so under ``warmup`` the first update has lr 0;
* clipping by value, then by global norm with optax's ``max_norm / norm``
  scale (no epsilon, unlike ``torch.nn.utils.clip_grad_norm_``);
* AdamW(beta1, beta2, eps 1e-8, weight_decay), whose update equals optax's.
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
