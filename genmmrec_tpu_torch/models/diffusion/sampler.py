"""Reverse-diffusion sampling (counterpart of
``genmmrec_tpu/models/diffusion/sampler.py``), as a Python loop over the
timesteps in place of ``lax.scan``."""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from genmmrec_tpu_torch.models.diffusion.schedule import (
    GaussianSchedule,
    _bcast,
    q_posterior_mean,
    q_sample,
)


def p_sample_loop(
    sched: GaussianSchedule,
    denoise_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    x_start: torch.Tensor,
    q_steps: int,
    generator: Optional[torch.Generator] = None,
    sampling_noise: bool = False,
    noise: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """DDPM reverse chain with an x0-predicting denoiser.

    ``q_steps`` forward-noising steps are applied to ``x_start`` first (0 =
    start from ``x_start``); the reverse loop always runs all
    ``sched.steps``. The noise, when any is drawn, comes from ``generator``,
    unless ``noise`` gives the planes in the chain's order
    (``chain_noise``). Every step is elementwise on the vectors, so the
    chain runs on a model rank's item columns alike, given the columns of
    the whole planes as ``noise``.
    """
    B = x_start.shape[0]
    noisy = q_steps > 0 or sampling_noise
    if noise is not None:
        planes = iter(noise)
        randn = lambda: next(planes)
    else:
        if noisy and generator is None:
            raise ValueError("a noisy reverse chain needs a generator")
        randn = lambda: torch.randn(x_start.shape, generator=generator, device=x_start.device)

    x = x_start
    if q_steps > 0:
        t0 = torch.full((B,), q_steps - 1, dtype=torch.int64, device=x.device)
        x = q_sample(sched, x_start, t0, randn())
    for i in range(sched.steps - 1, -1, -1):
        t = torch.full((B,), i, dtype=torch.int64, device=x.device)
        mean = q_posterior_mean(sched, denoise_fn(x, t), x, t)
        if sampling_noise and i != 0:
            logvar = _bcast(sched.posterior_log_variance_clipped, t, x)
            x = mean + torch.exp(0.5 * logvar) * randn()
        else:
            x = mean
    return x


def chain_noise(steps: int, q_steps: int, sampling_noise: bool, shape, generator, device) -> list:
    """The noise planes ``p_sample_loop`` draws for a batch of ``shape``, in
    its order: one for the forward noising when ``q_steps`` > 0, then one
    for each reverse step but the last when ``sampling_noise``."""
    n = (1 if q_steps > 0 else 0) + (steps - 1 if sampling_noise else 0)
    return [torch.randn(shape, generator=generator, device=device) for _ in range(n)]
