"""Shared loss functions (counterpart of ``genmmrec_tpu/common/losses.py``).

Pure functions with optional per-row weights, so padded batch rows
contribute nothing.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _wmean(x: torch.Tensor, weights: Optional[torch.Tensor]) -> torch.Tensor:
    if weights is None:
        return x.mean()
    return (x * weights).sum() / weights.sum().clamp(min=1.0)


def bpr_loss(pos_score, neg_score, weights=None, gamma: float = 1e-10) -> torch.Tensor:
    """-log σ(pos − neg), averaged; ``gamma=0`` takes the stable log-sigmoid form."""
    diff = pos_score - neg_score
    if gamma == 0.0:
        return _wmean(-F.logsigmoid(diff), weights)
    return _wmean(-torch.log(gamma + torch.sigmoid(diff)), weights)


def emb_loss(*embeddings: torch.Tensor, norm: int = 2) -> torch.Tensor:
    """Σ ‖E‖_p / batch, batch = rows of the last embedding."""
    batch = embeddings[-1].shape[0]
    return sum(torch.linalg.vector_norm(e.reshape(-1), ord=norm) for e in embeddings) / batch


def l2_loss(*embeddings: torch.Tensor) -> torch.Tensor:
    return sum(0.5 * (e**2).sum() for e in embeddings)


def exp_denominator_streamed(p1, e2, temperature: float, chunk: int = 8192) -> torch.Tensor:
    """``Σ_j exp(p1 · e2[j] / T)`` over row-chunks of ``e2``.

    Peak memory is O(B·chunk) instead of the one-shot (B, N) logits; each
    chunk's logits are recomputed in the backward (the counterpart of the
    JAX package's ``jax.checkpoint`` on the chunk body). Differs from the
    one-shot form only by summation order.
    """

    def part(c):
        return torch.exp(p1 @ c.T / temperature).sum(-1)

    deno = torch.zeros(p1.shape[0], dtype=p1.dtype, device=p1.device)
    for lo in range(0, e2.shape[0], chunk):
        deno = deno + checkpoint(part, e2[lo : lo + chunk], use_reentrant=False)
    return deno


def infonce(view1, view2, temperature: float, weights=None) -> torch.Tensor:
    """Row-aligned InfoNCE with in-batch negatives over normalized views."""
    v1 = F.normalize(view1, dim=1, eps=1e-12)
    v2 = F.normalize(view2, dim=1, eps=1e-12)
    logits = v1 @ v2.T / temperature
    return _wmean(torch.logsumexp(logits, dim=1) - logits.diagonal(), weights)
