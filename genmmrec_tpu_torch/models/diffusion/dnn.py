"""Denoiser MLP with a sinusoidal time embedding (counterpart of
``genmmrec_tpu/models/diffusion/dnn.py``).

``nn.Linear`` keeps its weight as (out, in), the layout of the JAX
package's ``{"w": (d_out, d_in), "b": (d_out,)}`` leaves, so parameters
copy across by name. The forward is the eval-mode pass unless it is given a
``dropout`` rate: training then drops input entries, with the keep mask
passed in or drawn from a generator.

``split_items`` puts the denoiser on a model axis's item split
(``parallel.mesh.ItemCols``): its input and output are this rank's columns
of the (B, n_items) vectors; the first in-layer's item columns give a
partial product summed over the axis, to which the time embedding's
columns and the bias are added once, and the last out-layer holds its rows
``[lo, hi)`` alone.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from genmmrec_tpu_torch.common.init import normal
from genmmrec_tpu_torch.parallel import mesh as pm


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
        # the model axis's item split (``split_items``); None on one device
        self.cols = None

    def split_items(self, cols: "pm.ItemCols") -> None:
        """Hold this rank's columns ``cols`` of the items: the last out-layer
        keeps its rows ``[lo, hi)`` alone (``pm.hold_item_rows``)."""
        pm.hold_item_rows(self.out_layers[-1], cols)
        self.cols = cols

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """normal(0, √(2/(fan_in+fan_out))) weights, normal(0, 1e-3) biases
        (drawn whole, and this rank's rows kept where it holds them)."""
        for layer in [self.emb_layer, *self.in_layers, *self.out_layers]:
            d_out, d_in = layer.out_features, layer.in_features
            pm.copy_rows_(layer.weight, normal((d_out, d_in), math.sqrt(2.0 / (d_in + d_out)), generator))
            pm.copy_rows_(layer.bias, normal((d_out,), 0.001, generator))

    def forward(
        self,
        x: torch.Tensor,
        t: torch.Tensor,
        dropout: float = 0.0,
        keep: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """``dropout`` > 0 zeroes the input entries where ``keep`` is False
        and scales the rest by 1/(1 − dropout); ``keep`` is drawn from
        ``generator`` when not given."""
        emb = self.emb_layer(timestep_embedding(t, self.emb_layer.in_features))
        if self.cols is not None:
            return self._forward_cols(x, emb, dropout, keep, generator)
        if self.norm:
            x = F.normalize(x, dim=-1, eps=1e-12)
        if dropout > 0.0:
            if keep is None:
                keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - dropout
            x = torch.where(keep, x / (1.0 - dropout), torch.zeros_like(x))
        h = torch.cat([x, emb], dim=-1)
        for layer in self.in_layers:
            h = torch.tanh(layer(h))
        for i, layer in enumerate(self.out_layers):
            h = layer(h)
            if i != len(self.out_layers) - 1:
                h = torch.tanh(h)
        return h

    def _forward_cols(self, x, emb, dropout, keep, generator) -> torch.Tensor:
        """The forward on this rank's columns ``x`` (B, hi − lo) → (B, hi −
        lo). Dropout takes its keep mask as given: this rank's columns of
        the whole mask (``DiffMM.diffusion_draws``)."""
        c = self.cols
        if self.norm:
            norm = c.enter(c.sum((x * x).sum(-1, keepdim=True)).sqrt())
            x = x / norm.clamp_min(1e-12)
        if dropout > 0.0:
            if keep is None:
                raise ValueError("on the item split the dropout keep mask is given (this rank's columns)")
            x = torch.where(keep, x / (1.0 - dropout), torch.zeros_like(x))
        first = self.in_layers[0]
        h = c.sum(x @ c.columns(first.weight).T) + emb @ first.weight[:, c.n :].T + first.bias
        for i, layer in enumerate(self.in_layers):
            h = torch.tanh(h if i == 0 else layer(h))
        for i, layer in enumerate(self.out_layers):
            last = i == len(self.out_layers) - 1
            h = layer(c.enter(h) if last else h)
            if not last:
                h = torch.tanh(h)
        return h
