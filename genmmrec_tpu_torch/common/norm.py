"""The scale and shift of a normalization, named as the JAX package's
``{"g": ones, "b": zeros}`` leaves (``b`` reads ``bias`` in the port, so
``interop.from_jax_params`` copies them across by name), with the two
normalizations that use them; and the row normalization of the
message-passing models (``l2n``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

EPS = 1e-5


class Norm(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.g = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def layer_norm(self, x: torch.Tensor) -> torch.Tensor:
        """Over the last dimension."""
        return F.layer_norm(x, (x.shape[-1],), self.g, self.bias, EPS)

    def batch_norm(self, x: torch.Tensor, rows=None) -> torch.Tensor:
        """Over the rows, with the population variance of the rows at hand
        (the whole node or item set) and no running statistics; over
        ``rows`` (``parallel.mesh.DataRows``) the statistics of every
        rank's rows (``batch_stats``)."""
        mu, var = batch_stats(x, 0, rows)
        return (x - mu) / torch.sqrt(var + EPS) * self.g + self.bias


def batch_stats(x: torch.Tensor, dims, rows=None):
    """The mean and population variance of ``x`` over ``dims`` (a dimension
    or a tuple of them, dim 0 the batch's rows among them), kept as
    dimensions of size 1. Over ``rows`` they are the global batch's: Σx /
    N, then Σ(x − μ)² / N (two passes, no cancellation), each sum over the
    data axis through ``rows.sum``, so the gradient reaches every rank's
    rows."""
    if rows is None:
        return x.mean(dim=dims, keepdim=True), x.var(dim=dims, keepdim=True, correction=0)
    count = rows.mesh.data
    for d in (dims if isinstance(dims, tuple) else (dims,)):
        count *= x.shape[d]
    mu = rows.sum(x.sum(dim=dims, keepdim=True)) / count
    var = rows.sum(((x - mu) ** 2).sum(dim=dims, keepdim=True)) / count
    return mu, var


def l2n(x: torch.Tensor) -> torch.Tensor:
    """Each row over its L2 norm, ``x / sqrt(Σx² + 1e-12)`` (the JAX models' ``_l2n``)."""
    return x / torch.sqrt((x * x).sum(-1, keepdim=True) + 1e-12)
