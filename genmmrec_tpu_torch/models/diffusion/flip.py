"""Binary flip ("interest") diffusion for GenRec-V1 (counterpart of
``genmmrec_tpu/models/diffusion/flip.py``).

- ``flip_schedules``: the sparsity-adaptive γ (0→1) and ε (1→0) flip
  schedules of a batch, as cumulative products;
- ``q_sample``: Bernoulli forward corruption through a temperature-scaled
  sigmoid of uniform noise;
- ``p_sample``: the reverse chain, a Python loop over ``steps-1 … 0``;
  with the Bayesian schedule each step but the last mixes the model's
  probabilities with the previous step's flip rates;
- ``true_posterior``, ``kl_to_posterior`` and ``infonce_rows``, the terms
  of the denoiser's loss.

Every draw is a uniform plane: ``jax.random.bernoulli(k, p)`` is
``uniform(k, p.shape) < p``. The uniforms come from a ``torch.Generator``
unless they are passed in, so that the tests can hand over the JAX
package's own.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def flip_schedules(x_start: torch.Tensor, steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gamma_cum, epsilon_cum), each (steps,), from the batch's sparsity."""
    sparsity = (x_start == 0).to(torch.float32).mean()
    gamma_start = 0.1 * (1.0 - sparsity) + 0.001
    gamma_end = gamma_start * 0.1
    epsilon_start = 0.005 * sparsity + 0.0001
    epsilon_end = epsilon_start * 0.1
    lin = torch.linspace(0.0, 1.0, steps, device=x_start.device)
    gamma = gamma_start + (gamma_end - gamma_start) * lin
    epsilon = (epsilon_start + (epsilon_end - epsilon_start) * lin).clamp(max=0.01)
    return 1.0 - torch.cumprod(1.0 - gamma, 0), 1.0 - torch.cumprod(1.0 - epsilon, 0)


def _uniform(shape, generator, device) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=device)


def q_sample(
    x_start: torch.Tensor,
    t: torch.Tensor,
    steps: int,
    base_temp: float = 1.0,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
    flip_u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Flip each entry with probability sigmoid((rate_t − noise)·base_temp),
    the rate γ_t for a 0 and ε_t for a 1. ``noise`` and the flip uniforms
    ``flip_u`` ((B, n) each) are drawn from ``generator`` unless given."""
    gamma_cum, epsilon_cum = flip_schedules(x_start, steps)
    a0 = gamma_cum[t][:, None]
    a1 = epsilon_cum[t][:, None]
    if noise is None:
        noise = _uniform(x_start.shape, generator, x_start.device)
    if flip_u is None:
        flip_u = _uniform(x_start.shape, generator, x_start.device)
    flip_prob = torch.where(
        x_start == 0, torch.sigmoid((a0 - noise) * base_temp), torch.sigmoid((a1 - noise) * base_temp)
    )
    return torch.where(flip_u < flip_prob, 1.0 - x_start, x_start)


def p_sample(
    denoise_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    x_start: torch.Tensor,
    steps: int,
    q_steps: int,
    base_temp: float = 1.0,
    bayesian: bool = True,
    generator: Optional[torch.Generator] = None,
    init: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    step_u: Optional[Sequence[torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reverse flip sampling → (x_0 sample, the last step's probabilities).

    With ``q_steps`` > 0 the chain starts from ``q_sample`` at
    ``t = q_steps − 1``, whose (noise, flip) uniforms ``init`` gives;
    ``step_u`` gives one uniform plane per reverse step, in the loop's
    order (t = steps−1 first). Both are drawn from ``generator`` unless
    given."""
    B = x_start.shape[0]
    dev = x_start.device
    gamma_cum, epsilon_cum = flip_schedules(x_start, steps)
    if q_steps == 0:
        x = x_start
    else:
        t0 = torch.full((B,), q_steps - 1, dtype=torch.int64, device=dev)
        noise, flip_u = init if init is not None else (None, None)
        x = q_sample(x_start, t0, steps, base_temp, generator, noise, flip_u)
    probs = torch.zeros_like(x)
    for j, i in enumerate(range(steps - 1, -1, -1)):
        t = torch.full((B,), i, dtype=torch.int64, device=dev)
        probs = torch.sigmoid(denoise_fn(x, t))
        p = probs
        if bayesian and i > 0:
            prev_a0, prev_a1 = gamma_cum[i - 1], epsilon_cum[i - 1]
            p0 = probs * (1.0 - prev_a0) + (1.0 - probs) * prev_a1
            p1 = probs * prev_a0 + (1.0 - probs) * (1.0 - prev_a1)
            p = p1 / (p0 + p1)
        u = step_u[j] if step_u is not None else _uniform(p.shape, generator, dev)
        x = (u < p).to(x.dtype)
    return x, probs


def true_posterior(x0, t, gamma_cum, epsilon_cum, eps: float = 1e-8) -> torch.Tensor:
    a0 = gamma_cum[t][:, None]
    a1 = epsilon_cum[t][:, None]
    is0 = (x0 == 0).to(torch.float32)
    is1 = (x0 == 1).to(torch.float32)
    numerator = is0 * (1.0 - a0) + is1 * a1
    denominator = is0 * (1.0 - a0 + a1) + is1 * (a0 + 1.0 - a1)
    return numerator / (denominator + eps)


def kl_to_posterior(x0, t, probs, steps: int, eps: float = 1e-8) -> torch.Tensor:
    """Per-row KL of the true flip posterior to the model's probabilities;
    neither side carries a gradient, as in the reference."""
    gamma_cum, epsilon_cum = flip_schedules(x0, steps)
    post = true_posterior(x0, t, gamma_cum, epsilon_cum).clamp(eps, 1 - eps).detach()
    p = probs.detach().clamp(eps, 1 - eps)
    kl = post * (torch.log(post + 1e-10) - torch.log(p + 1e-10))
    kl = kl + (1 - post) * (torch.log(1 - post + 1e-10) - torch.log(1 - p + 1e-10))
    return kl.mean(dim=1)


def infonce_rows(view1, view2, temperature: float) -> torch.Tensor:
    """Mean InfoNCE of each row of ``view1`` against every row of ``view2``."""
    v1 = F.normalize(view1, dim=1, eps=1e-12)
    v2 = F.normalize(view2, dim=1, eps=1e-12)
    pos = torch.exp((v1 * v2).sum(-1) / temperature)
    neg = torch.exp(v1 @ v2.T / temperature).sum(1)
    return -torch.log(pos / neg).mean()
