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

    def batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        """Over the rows, with the population variance of the rows at hand
        (the whole node or item set) and no running statistics."""
        mu = x.mean(dim=0, keepdim=True)
        var = x.var(dim=0, keepdim=True, correction=0)
        return (x - mu) / torch.sqrt(var + EPS) * self.g + self.bias


def l2n(x: torch.Tensor) -> torch.Tensor:
    """Each row over its L2 norm, ``x / sqrt(Σx² + 1e-12)`` (the JAX models' ``_l2n``)."""
    return x / torch.sqrt((x * x).sum(-1, keepdim=True) + 1e-12)
