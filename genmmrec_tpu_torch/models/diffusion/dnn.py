"""Denoiser MLP with a sinusoidal time embedding (counterpart of
``genmmrec_tpu/models/diffusion/dnn.py``).

``nn.Linear`` keeps its weight as (out, in), the layout of the JAX
package's ``{"w": (d_out, d_in), "b": (d_out,)}`` leaves, so parameters
copy across by name. The forward is the eval-mode pass (no dropout), as
the serving path runs it; dropout comes with training.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from genmmrec_tpu_torch.common.init import normal


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = t[:, None].to(torch.float32) * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class Denoise(nn.Module):
    """time embedding → emb layer; input = concat(x, emb); tanh in/out towers."""

    def __init__(self, in_dims: Sequence[int], out_dims: Sequence[int], emb_size: int, norm: bool = False):
        super().__init__()
        if out_dims[0] != in_dims[-1]:
            raise ValueError("In and out dimensions must equal to each other.")
        self.norm = norm
        in_dims_temp = [in_dims[0] + emb_size] + list(in_dims[1:])
        self.emb_layer = nn.Linear(emb_size, emb_size)
        self.in_layers = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(in_dims_temp[:-1], in_dims_temp[1:])
        )
        self.out_layers = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(out_dims[:-1], out_dims[1:])
        )

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """normal(0, √(2/(fan_in+fan_out))) weights, normal(0, 1e-3) biases."""
        for layer in [self.emb_layer, *self.in_layers, *self.out_layers]:
            d_out, d_in = layer.weight.shape
            layer.weight.copy_(normal((d_out, d_in), math.sqrt(2.0 / (d_in + d_out)), generator))
            layer.bias.copy_(normal((d_out,), 0.001, generator))

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        emb = self.emb_layer(timestep_embedding(t, self.emb_layer.in_features))
        if self.norm:
            x = F.normalize(x, dim=-1, eps=1e-12)
        h = torch.cat([x, emb], dim=-1)
        for layer in self.in_layers:
            h = torch.tanh(layer(h))
        for i, layer in enumerate(self.out_layers):
            h = layer(h)
            if i != len(self.out_layers) - 1:
                h = torch.tanh(h)
        return h
