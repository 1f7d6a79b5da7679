"""Top-K ranking metrics on a boolean hit matrix (counterpart of
``genmmrec_tpu/engine/metrics.py``).

Each metric returns its value at every rank position ``1..K`` (callers pick
``k-1``) and takes a per-row ``weights`` vector, so padded or out-of-group
user rows count with weight 0.
"""

from __future__ import annotations

import torch


def _wmean(rows: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    denom = torch.clamp(weights.sum(), min=1.0)
    return (rows * weights[:, None]).sum(dim=0) / denom


def _ranks(K: int, device) -> torch.Tensor:
    return torch.arange(1, K + 1, dtype=torch.float32, device=device)


def recall_at(hits, pos_len, weights):
    rec = torch.cumsum(hits.float(), dim=1) / torch.clamp(pos_len, min=1)[:, None]
    return _wmean(rec, weights)


def recall2_at(hits, pos_len, weights):
    cum = torch.cumsum(hits.float(), dim=1) * weights[:, None]
    denom = torch.clamp((pos_len * weights).sum(), min=1.0)
    return cum.sum(dim=0) / denom


def ndcg_at(hits, pos_len, weights):
    K = hits.shape[1]
    gains = 1.0 / torch.log2(_ranks(K, hits.device) + 1.0)
    base_idcg = torch.cumsum(gains, dim=0)
    # idcg at column j is base_idcg[min(j, pos_len - 1)]
    idcg_len = torch.clamp(pos_len, 1, K).long()
    col = torch.minimum(torch.arange(K, device=hits.device)[None, :], idcg_len[:, None] - 1)
    idcg = base_idcg[col]
    dcg = torch.cumsum(torch.where(hits, gains[None, :], 0.0), dim=1)
    return _wmean(dcg / idcg, weights)


def map_at(hits, pos_len, weights):
    K = hits.shape[1]
    ranks = _ranks(K, hits.device)
    hits_f = hits.float()
    pre = torch.cumsum(hits_f, dim=1) / ranks[None, :]
    sum_pre = torch.cumsum(pre * hits_f, dim=1)
    actual_len = torch.clamp(pos_len, 1, K).float()
    denom = torch.minimum(ranks[None, :], actual_len[:, None])
    return _wmean(sum_pre / denom, weights)


def precision_at(hits, pos_len, weights):
    K = hits.shape[1]
    pre = torch.cumsum(hits.float(), dim=1) / _ranks(K, hits.device)[None, :]
    return _wmean(pre, weights)


metrics_dict = {
    "recall": recall_at,
    "recall2": recall2_at,
    "ndcg": ndcg_at,
    "map": map_at,
    "precision": precision_at,
}


def gini_index(counts: torch.Tensor) -> torch.Tensor:
    """Gini over per-item recommendation counts."""
    n = counts.shape[0]
    sorted_counts = torch.sort(counts).values
    total = sorted_counts.sum()
    index = torch.arange(1, n + 1, dtype=torch.float32, device=counts.device)
    gini = (2.0 * (index * sorted_counts).sum()) / (n * torch.clamp(total, min=1.0)) - (n + 1.0) / n
    return torch.where(total > 0, gini, torch.zeros_like(gini))


def gini_trapz(counts: torch.Tensor, n_active: torch.Tensor) -> torch.Tensor:
    """Trapezoidal Lorenz-curve Gini over the active items only, with a
    prepended zero (the reference's ``cal_gini``), on a fixed-size sorted
    vector whose inactive entries sort to the front as zeros."""
    n_items = counts.shape[0]
    s = torch.sort(torch.cat([counts, counts.new_zeros(1)])).values
    cum = torch.cumsum(s, dim=0)
    total = torch.clamp(cum[-1], min=1.0)
    idx = torch.arange(n_items + 1, dtype=torch.float32, device=counts.device)
    window = idx >= (n_items - n_active)
    y = torch.where(window, cum / total, torch.zeros_like(cum))
    yN = cum[-1] / total
    h = 1.0 / torch.clamp(n_active, min=1.0)
    B = h * (y.sum() - 0.5 * yN)
    A = 0.5 - B
    g = A / torch.clamp(A + B, min=1e-12)
    return torch.where(n_active > 0, g, torch.zeros_like(g))
