"""Gaussian diffusion schedules (counterpart of
``genmmrec_tpu/models/diffusion/schedule.py``).

The tables are computed on the host in float64 with the JAX package's
numpy code and kept in float64 on the device; each use casts the gathered
entries to the operand's dtype, so a float32 operand sees the same float32
coefficients as the JAX package's float32 tables.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def betas_from_linear_variance(steps: int, variance: np.ndarray, max_beta: float = 0.999) -> np.ndarray:
    alpha_bar = 1.0 - variance
    betas = [1.0 - alpha_bar[0]]
    for i in range(1, steps):
        betas.append(min(1.0 - alpha_bar[i] / alpha_bar[i - 1], max_beta))
    return np.array(betas, dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class GaussianSchedule:
    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    steps: int


def make_schedule(
    noise_schedule: str,
    noise_scale: float,
    noise_min: float,
    noise_max: float,
    steps: int,
    device=None,
    beta_fixed: bool = True,
    beta_fixed_value: float = 0.00001,
) -> GaussianSchedule:
    """``beta_fixed_value``: DiffRec pins β₀=1e-5; DiffMM pins 1e-4."""
    start = noise_scale * noise_min
    end = noise_scale * noise_max
    lin = np.linspace(start, end, steps, dtype=np.float64)
    if noise_schedule == "linear-var":
        betas = betas_from_linear_variance(steps, lin)
    else:  # "linear" and fallback
        betas = lin.copy()
    if beta_fixed:
        betas[0] = beta_fixed_value
    if not ((betas > 0).all() and (betas <= 1).all()):
        raise ValueError("betas out of range")

    alphas = 1.0 - betas
    acp = np.cumprod(alphas)
    acp_prev = np.concatenate([[1.0], acp[:-1]])
    post_var = betas * (1.0 - acp_prev) / (1.0 - acp)
    post_logvar = np.log(np.concatenate([[post_var[1]], post_var[1:]]))
    coef1 = betas * np.sqrt(acp_prev) / (1.0 - acp)
    coef2 = (1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp)

    f64 = lambda x: torch.as_tensor(x, dtype=torch.float64, device=device)
    return GaussianSchedule(
        betas=f64(betas),
        alphas_cumprod=f64(acp),
        alphas_cumprod_prev=f64(acp_prev),
        sqrt_alphas_cumprod=f64(np.sqrt(acp)),
        sqrt_one_minus_alphas_cumprod=f64(np.sqrt(1.0 - acp)),
        posterior_variance=f64(post_var),
        posterior_log_variance_clipped=f64(post_logvar),
        posterior_mean_coef1=f64(coef1),
        posterior_mean_coef2=f64(coef2),
        steps=steps,
    )


def _bcast(arr: torch.Tensor, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """arr[t] in ``like``'s dtype, broadcast against ``like`` (t is (B,))."""
    res = arr[t].to(like.dtype)
    return res.reshape(res.shape + (1,) * (like.dim() - 1))


def q_sample(sched: GaussianSchedule, x_start, t, noise) -> torch.Tensor:
    return (
        _bcast(sched.sqrt_alphas_cumprod, t, x_start) * x_start
        + _bcast(sched.sqrt_one_minus_alphas_cumprod, t, x_start) * noise
    )


def q_posterior_mean(sched: GaussianSchedule, x_start, x_t, t) -> torch.Tensor:
    return (
        _bcast(sched.posterior_mean_coef1, t, x_t) * x_start
        + _bcast(sched.posterior_mean_coef2, t, x_t) * x_t
    )


def snr(sched: GaussianSchedule, t: torch.Tensor) -> torch.Tensor:
    """ᾱ_t / (1 − ᾱ_t) in float32, as from the JAX package's float32 table;
    t = -1 wraps to the last step (the reference's ``SNR(ts - 1)`` at t = 0)."""
    acp = sched.alphas_cumprod[t].to(torch.float32)
    return acp / (1.0 - acp)
