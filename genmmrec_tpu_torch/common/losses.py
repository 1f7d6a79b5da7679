"""Shared loss functions (counterpart of ``genmmrec_tpu/common/losses.py``).

Pure functions with optional per-row weights, so padded batch rows
contribute nothing. ``rows`` (``parallel.mesh.DataRows``) is this rank's
share of a batch split over the data axis: a loss then returns this rank's
share of the global loss (its rows' terms over the global denominator).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def weighted_mean(x: torch.Tensor, weights: torch.Tensor, rows=None) -> torch.Tensor:
    """Σ x·w / max(Σw, 1) over the batch's rows; over ``rows`` this rank's
    rows over the global batch's Σw."""
    den = weights.sum() if rows is None else rows.count(weights.sum())
    return (x * weights).sum() / den.clamp(min=1.0)


def _wmean(x: torch.Tensor, weights: Optional[torch.Tensor], rows=None) -> torch.Tensor:
    return x.mean() if weights is None else weighted_mean(x, weights, rows)


def row_mean(x: torch.Tensor, rows=None) -> torch.Tensor:
    """``x.mean()`` of a tensor of the batch's rows (on dim 0); over ``rows``
    this rank's share: its entries' sum over the global batch's count."""
    return x.mean() if rows is None else x.sum() / (x.numel() * rows.mesh.data)


def global_mean(x: torch.Tensor, rows=None) -> torch.Tensor:
    """The mean of a tensor of the batch's rows over the global batch, the
    same on every rank; over ``rows`` it carries no gradient."""
    return x.mean() if rows is None else rows.count(x.sum()) / (x.numel() * rows.mesh.data)


def table_share(x: torch.Tensor, rows=None) -> torch.Tensor:
    """A term over whole tables, not the batch's rows; over ``rows`` this
    rank's share of it."""
    return x if rows is None else x * rows.share


def batch_rows(x: torch.Tensor, rows=None) -> torch.Tensor:
    """The batch's rows of a per-row tensor: over ``rows`` every rank's, in
    the global order, carrying the gradient (in-batch negatives)."""
    return x if rows is None else rows.gather(x)


def bpr_loss(pos_score, neg_score, weights=None, gamma: float = 1e-10, rows=None) -> torch.Tensor:
    """-log σ(pos − neg), averaged; ``gamma=0`` takes the stable log-sigmoid form."""
    diff = pos_score - neg_score
    if gamma == 0.0:
        return _wmean(-F.logsigmoid(diff), weights, rows)
    return _wmean(-torch.log(gamma + torch.sigmoid(diff)), weights, rows)


def emb_loss(*embeddings: torch.Tensor, norm: int = 2, rows=None) -> torch.Tensor:
    """Σ ‖E‖_p / batch, batch = rows of the last embedding. Over ``rows``
    the norms are of the global rows (p = 2), and the term is shared."""
    if rows is None:
        batch = embeddings[-1].shape[0]
        return sum(torch.linalg.vector_norm(e.reshape(-1), ord=norm) for e in embeddings) / batch
    if norm != 2:
        raise NotImplementedError("emb_loss over a data axis takes the 2-norm")
    return sum(rows.sum((e * e).sum()).sqrt() for e in embeddings) / rows.n * rows.share


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
