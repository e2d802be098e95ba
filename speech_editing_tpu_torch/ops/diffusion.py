"""DDPM schedule and posterior sampling for the x0-predicting mel denoiser.

Mel tensors are feature-last ``[B, T, M]``; ``t`` is an integer ``[B]``
tensor indexing buffers of length ``timesteps + 1``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def _vpsde_beta_t(t: int, big_t: int, min_beta: float, max_beta: float) -> float:
    t_coef = (2 * t - 1) / (big_t ** 2)
    return 1.0 - float(np.exp(-min_beta / big_t - 0.5 * (max_beta - min_beta) * t_coef))


def _logsnr_cosine(t: float, logsnr_min: float, logsnr_max: float) -> float:
    b = np.arctan(np.exp(-0.5 * logsnr_max))
    a = np.arctan(np.exp(-0.5 * logsnr_min)) - b
    return float(-2.0 * np.log(np.tan(a * t + b)))


def get_noise_schedule_list(schedule_mode: str, timesteps: int,
                            min_beta: float = 0.0, max_beta: float = 0.01,
                            s: float = 0.008) -> np.ndarray:
    if schedule_mode == "linear":
        return np.linspace(1e-6, 0.01, timesteps)
    if schedule_mode == "cosine":
        steps = timesteps + 1
        x = np.linspace(0, steps, steps)
        ac = np.cos(((x / steps) + s) / (1 + s) * np.pi * 0.5) ** 2
        ac = ac / ac[0]
        return np.clip(1 - (ac[1:] / ac[:-1]), 0, 0.999)
    if schedule_mode == "vpsde":
        return np.array([_vpsde_beta_t(t, timesteps, min_beta, max_beta)
                         for t in range(1, timesteps + 1)])
    if schedule_mode == "logsnr":
        return np.array([_logsnr_cosine(t / timesteps, -20.0, 20.0)
                         for t in range(1, timesteps + 1)])
    raise NotImplementedError(schedule_mode)


@dataclass(frozen=True)
class DiffusionSchedule:
    """float32 buffers of length timesteps+1, computed in float64 on the host."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    num_timesteps: int

    @classmethod
    def create(cls, schedule_type: str = "vpsde", timesteps: int = 8,
               min_beta: float = 0.1, max_beta: float = 40.0,
               s: float = 0.008, device="cpu") -> "DiffusionSchedule":
        betas = np.asarray(get_noise_schedule_list(
            schedule_type, timesteps + 1, min_beta, max_beta, s), np.float64)
        alphas = 1.0 - betas
        ac = np.cumprod(alphas)
        ac_prev = np.append(1.0, ac[:-1])
        post_var = betas * (1.0 - ac_prev) / (1.0 - ac)

        def f32(x):
            return torch.tensor(np.asarray(x, np.float32), device=device)

        return cls(
            betas=f32(betas),
            alphas_cumprod=f32(ac),
            sqrt_alphas_cumprod=f32(np.sqrt(ac)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - ac)),
            posterior_mean_coef1=f32(betas * np.sqrt(ac_prev) / (1.0 - ac)),
            posterior_mean_coef2=f32((1.0 - ac_prev) * np.sqrt(alphas) / (1.0 - ac)),
            posterior_log_variance_clipped=f32(np.log(np.maximum(post_var, 1e-20))),
            num_timesteps=int(timesteps))


def _bcast(buf: torch.Tensor, t: torch.Tensor, ndim: int, dtype=None) -> torch.Tensor:
    """``buf[t]`` shaped to broadcast over an ``ndim`` tensor with a leading
    batch, cast to ``dtype`` when given: the activations' dtype, so that a
    float32 coefficient does not promote a bf16 path back to float32."""
    out = buf[t].reshape(t.shape[0], *([1] * (ndim - 1)))
    return out if dtype is None else out.to(dtype)


def q_sample(sched: DiffusionSchedule, x_start: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """Forward-diffuse x0 to x_t, in the dtype of ``x_start``."""
    d, nd = x_start.dtype, x_start.ndim
    return (_bcast(sched.sqrt_alphas_cumprod, t, nd, d) * x_start
            + _bcast(sched.sqrt_one_minus_alphas_cumprod, t, nd, d) * noise.to(d))


def diffuse(sched: DiffusionSchedule, x_start: torch.Tensor, t: torch.Tensor,
            noise: torch.Tensor) -> torch.Tensor:
    """q_sample, with ``t == -1`` returning the ground truth."""
    neg = (t < 0).reshape(-1, *([1] * (x_start.ndim - 1)))
    out = q_sample(sched, x_start, t.clamp(min=0), noise)
    return torch.where(neg, x_start, out)


def q_posterior_sample(sched: DiffusionSchedule, x0_pred: torch.Tensor,
                       x_t: torch.Tensor, t: torch.Tensor,
                       noise: torch.Tensor) -> torch.Tensor:
    """Sample x_{t-1} ~ q(x_{t-1} | x_t, x0_pred) with the given noise;
    deterministic at t=0."""
    d, nd = x_t.dtype, x_t.ndim
    mean = (_bcast(sched.posterior_mean_coef1, t, nd, d) * x0_pred.to(d)
            + _bcast(sched.posterior_mean_coef2, t, nd, d) * x_t)
    log_var = _bcast(sched.posterior_log_variance_clipped, t, nd, d)
    nonzero = (t > 0).to(x_t.dtype).reshape(-1, *([1] * (nd - 1)))
    return mean + nonzero * torch.exp(0.5 * log_var) * noise.to(d)
