"""Importance-sampled timesteps over a loss-history buffer (counterpart of
``genmmrec_tpu/models/diffusion/importance.py``).

Until every timestep has ``history_num_per_term`` recorded losses, the
timesteps are uniform; then t ∝ sqrt(E[L_t²]) with an ``uniform_prob``
floor, and ``pt`` (the proposal probability times the number of steps) is
what the loss is divided by.

The buffer is a ring per timestep: a batch's rows of timestep t fill the
slots ``(count[t] + occurrence) % H`` in batch order. A batch with more
than H rows of one timestep writes a slot more than once; the last of
those rows in batch order wins (``scatter_last``), the winner XLA's CPU
scatter picks for the JAX package's ``.at[].set``, and a rule that does not
depend on the device (``index_put_`` with repeated indices on CUDA does).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def init_lt_state(steps: int, history_num_per_term: int = 10, device=None) -> dict:
    return {
        "Lt_history": torch.zeros(steps, history_num_per_term, device=device),
        "Lt_count": torch.zeros(steps, dtype=torch.int64, device=device),
    }


def timestep_probs(lt_state, uniform_prob: float = 0.001) -> Tuple[torch.Tensor, torch.Tensor]:
    """(steps,) proposal probabilities and a 0-d bool, whether the history
    is full: uniform until it is, then sqrt(E[L_t²]) normalized and
    floored. Both stay on the device."""
    hist, count = lt_state["Lt_history"], lt_state["Lt_count"]
    steps, H = hist.shape
    ready = (count == H).all()
    lt_sqrt = torch.sqrt((hist**2).mean(dim=-1))
    pt_imp = lt_sqrt / lt_sqrt.sum().clamp(min=1e-12)
    pt_imp = pt_imp * (1.0 - uniform_prob) + uniform_prob / steps
    return torch.where(ready, pt_imp, torch.full_like(pt_imp, 1.0 / steps)), ready


def sample_timesteps(
    lt_state,
    batch_size: int,
    method: str = "uniform",
    uniform_prob: float = 0.001,
    generator: Optional[torch.Generator] = None,
    t: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(t, pt), each (batch_size,). ``t`` is drawn from ``generator``
    (uniform, or from the proposal with ``method="importance"``) unless
    given; ``pt`` is 1 until the history is full, then the proposal
    probability of t times the number of steps."""
    steps = lt_state["Lt_history"].shape[0]
    dev = lt_state["Lt_history"].device
    ones = torch.ones(batch_size, device=dev)
    if method != "importance":
        if t is None:
            t = torch.randint(0, steps, (batch_size,), generator=generator, device=dev)
        return t, ones
    pt_all, ready = timestep_probs(lt_state, uniform_prob)
    if t is None:
        t = torch.multinomial(pt_all, batch_size, replacement=True, generator=generator)
    return t, torch.where(ready, pt_all[t] * steps, ones)


def scatter_last(target: torch.Tensor, index: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """A copy of the flat ``target`` with ``values[j]`` at ``index[j]``;
    where an index repeats, the last j in order wins. The winners are
    chosen first (a max-reduction of the row numbers), so the write has no
    repeated index and no host synchronization."""
    rows = torch.arange(index.shape[0], device=index.device)
    winner = torch.full(target.shape, -1, dtype=torch.int64, device=target.device)
    winner = winner.scatter_reduce(0, index, rows, "amax", include_self=True)
    return torch.where(winner >= 0, values[winner.clamp(min=0)].to(target.dtype), target)


def occurrence(t: torch.Tensor) -> torch.Tensor:
    """For each row, how many earlier rows share its value."""
    order = torch.sort(t, stable=True).indices
    t_sorted = t[order]
    first = torch.searchsorted(t_sorted, t_sorted)
    occ = torch.empty_like(t)
    occ[order] = torch.arange(t.shape[0], device=t.device) - first
    return occ


def update_lt_state(lt_state, t: torch.Tensor, losses: torch.Tensor, weights=None) -> dict:
    """Record the rows' losses (detached) in their timesteps' rings; rows of
    weight 0 (padding) are left out. Each row goes to slot ``(count[t] +
    occurrence) % H``; a slot written twice keeps the later row's loss."""
    hist, count = lt_state["Lt_history"], lt_state["Lt_count"]
    steps, H = hist.shape
    t = t.to(torch.int64)
    valid = torch.ones_like(t, dtype=torch.bool) if weights is None else weights > 0
    t = torch.where(valid, t, steps)
    slot = (count[t.clamp(max=steps - 1)] + occurrence(t)) % H
    # a padding row writes one spare slot past the buffer, cut off after
    key = torch.where(valid, t * H + slot, steps * H)
    spare = torch.cat([hist.reshape(-1), hist.new_zeros(1)])
    new_hist = scatter_last(spare, key, losses.detach())[:-1].reshape(steps, H)
    added = torch.bincount(t, minlength=steps + 1)[:steps]
    return {"Lt_history": new_hist, "Lt_count": (count + added).clamp(max=H)}
