"""ModalDenoiseTransformer, GenRec-V1's flip-diffusion denoiser
(counterpart of ``genmmrec_tpu/models/modal_denoise.py``).

A sinusoidal time embedding through a linear layer, an input projection of
[x ; time_emb] to ``dim_feedforward``, adaLN time modulation (shift and
scale), a stack of post-LN decoder layers over a length-1 sequence with a
zero memory, and a GELU output head. Over one position the self-attention
is ``sa_o(sa_v(h))`` (a softmax over one key is 1), and the cross-attention
against a zero memory is the constant ``ca_o(ca_bv)``, computed once per
layer and added to every row.

Parameter names follow the JAX pytree: linear layers are ``nn.Linear``
(``{"w", "b"}`` there), the layer norms hold ``g`` and ``bias`` (``{"g",
"b"}``), each layer's cross-attention value bias is ``ca_bv``, so
``interop.from_jax_params`` copies the tree across by name. ``time_emb1``
and ``time_emb2`` are part of that tree and, as in the JAX package, not of
the forward.

``split_items`` puts it on a model axis's item split
(``parallel.mesh.ItemCols``): ``input_proj``'s item columns give a partial
product summed over the axis (the time embedding's columns and the bias
added once), ``out2`` holds its rows ``[lo, hi)`` alone, and the 512-wide
layers and their norms stay whole on every rank.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from genmmrec_tpu_torch.common.init import xavier_uniform
from genmmrec_tpu_torch.common.norm import Norm
from genmmrec_tpu_torch.models.diffusion.dnn import timestep_embedding
from genmmrec_tpu_torch.parallel import mesh as pm


class _Layer(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.sa_v, self.sa_o = nn.Linear(d, d), nn.Linear(d, d)
        self.ln1 = Norm(d)
        self.ca_bv = nn.Parameter(torch.full((d,), 0.01))
        self.ca_o = nn.Linear(d, d)
        self.ln2 = Norm(d)
        self.ff1, self.ff2 = nn.Linear(d, d), nn.Linear(d, d)
        self.ln3 = Norm(d)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        h = self.ln1.layer_norm(h + self.sa_o(self.sa_v(h)))
        h = self.ln2.layer_norm(h + self.ca_o(self.ca_bv))
        return self.ln3.layer_norm(h + self.ff2(F.relu(self.ff1(h))))


class ModalDenoise(nn.Module):
    def __init__(self, in_dims: int, out_dims: int, emb_size: int, num_layers: int = 6, dim_feedforward: int = 512):
        super().__init__()
        d = dim_feedforward
        self.time_emb1 = nn.Linear(emb_size, 4 * emb_size)
        self.time_emb2 = nn.Linear(4 * emb_size, emb_size)
        self.emb_layer = nn.Linear(emb_size, emb_size)
        self.input_proj = nn.Linear(in_dims + emb_size, d)
        self.adaLN = nn.Linear(emb_size, 2 * d)
        self.out1 = nn.Linear(d, d // 2)
        self.out_ln = Norm(d // 2)
        self.out2 = nn.Linear(d // 2, out_dims)
        self.layers = nn.ModuleList(_Layer(d) for _ in range(num_layers))
        # the model axis's item split (``split_items``); None on one device
        self.cols = None

    def split_items(self, cols: "pm.ItemCols") -> None:
        """Hold this rank's columns ``cols`` of the items: ``out2`` keeps its
        rows ``[lo, hi)`` alone (``pm.hold_item_rows``)."""
        pm.hold_item_rows(self.out2, cols)
        self.cols = cols

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """Xavier-uniform weights, 0.01 biases (and ``ca_bv``), unit layer
        norms, all drawn from ``generator`` (drawn whole, and this rank's
        rows kept where it holds them)."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                pm.copy_rows_(m.weight, xavier_uniform((m.out_features, m.in_features), generator))
                m.bias.fill_(0.01)
            elif isinstance(m, Norm):
                m.g.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, _Layer):
                m.ca_bv.fill_(0.01)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        time_emb = self.emb_layer(timestep_embedding(t, self.emb_layer.in_features))
        c = self.cols
        if c is None:
            h = self.input_proj(torch.cat([x, time_emb], dim=-1))
        else:
            w = self.input_proj.weight
            h = c.sum(x @ c.columns(w).T) + time_emb @ w[:, c.n :].T + self.input_proj.bias
        shift, scale = self.adaLN(F.silu(time_emb)).chunk(2, dim=-1)
        h = h * (1.0 + scale) + shift
        for layer in self.layers:
            h = layer(h)
        out = F.gelu(self.out_ln.layer_norm(self.out1(h)), approximate="tanh")
        return self.out2(out if c is None else c.enter(out))
