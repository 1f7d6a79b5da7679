"""MMGCN: multi-modal graph convolution network (counterpart of
``genmmrec_tpu/models/mmgcn.py``).

One GCN tower per modality over the symmetric user-item edges, sorted by
destination once (``ops/mp.py``). Each of its three layers propagates
``x @ W`` by the neighbour mean (K1, ``propagate(..., "mean")``), combines
the ids (``x_hat = leaky(lin(x)) + id_embedding``) and fuses
``leaky(g(cat(h, x_hat)))``: the reference's ``concate='False'`` is a
truthy string, so its concatenating branch is the one ported. The visual
tower first projects the features to a 256-wide latent; the text tower
propagates its raw 384-wide features in layer 1. The towers' outputs are
averaged; BPR over the [[1], [-1]] score product plus the id and
preference regularizer.

``conv{i}_w`` is applied as ``x @ W`` and kept in the JAX package's (in,
out) layout; the linear layers are ``nn.Linear`` ((out, in), ``x @ Wᵀ``).
The id embedding and the preferences are trainable, as in the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from genmmrec_tpu_torch.common.init import init_linear, uniform, xavier_normal
from genmmrec_tpu_torch.common.losses import bpr_loss, row_mean, table_share
from genmmrec_tpu_torch.models.base import RecModel, scalar
from genmmrec_tpu_torch.ops.graph import unique_ui_pairs
from genmmrec_tpu_torch.ops.mp import message_graph, propagate, sort_edges_by_dst


def lrelu(x):
    return F.leaky_relu(x, 0.01)


class _Tower(nn.Module):
    def __init__(self, n_users: int, dim_feat: int, dim_latent, dim_x: int, device):
        super().__init__()
        d_in = dim_latent or dim_feat
        self.preference = nn.Parameter(torch.empty(n_users, d_in, device=device))
        if dim_latent:
            self.mlp = nn.Linear(dim_feat, dim_latent, device=device)
        widths = ((d_in, dim_x), (dim_x, dim_x), (dim_x, dim_x))
        for li, (w_in, _) in enumerate(widths, 1):
            self.register_parameter(f"conv{li}_w", nn.Parameter(torch.empty(w_in, w_in, device=device)))
            setattr(self, f"lin{li}", nn.Linear(w_in, dim_x, device=device))
            setattr(self, f"g{li}", nn.Linear(w_in + dim_x, dim_x, device=device))

    @torch.no_grad()
    def init_params(self, generator):
        self.preference.copy_(xavier_normal(self.preference.shape, generator))
        for li in (1, 2, 3):
            w = getattr(self, f"conv{li}_w")
            w.copy_(uniform(w.shape, 1.0 / math.sqrt(w.shape[0]), generator))
            init_linear(getattr(self, f"lin{li}"), generator, zero_bias=True)
            init_linear(getattr(self, f"g{li}"), generator, zero_bias=True)
        if hasattr(self, "mlp"):
            init_linear(self.mlp, generator, zero_bias=True)

    def forward(self, features, id_embedding, graph):
        feats = self.mlp(features) if hasattr(self, "mlp") else features
        x = torch.cat([self.preference, feats])
        x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-12)
        for li in (1, 2, 3):
            h = lrelu(propagate(x @ getattr(self, f"conv{li}_w"), graph, "mean"))
            x_hat = lrelu(getattr(self, f"lin{li}")(x)) + id_embedding
            x = lrelu(getattr(self, f"g{li}")(torch.cat([h, x_hat], dim=1)))
        return x


class MMGCN(RecModel):
    def __init__(self, config, data):
        super().__init__(config, data)
        self.dim_x = scalar(config["embedding_size"], int)
        self.reg_weight = scalar(config["reg_weight"])
        self.dim_latent_v = 256
        self.N = self.n_users + self.n_items
        users, items = unique_ui_pairs(data.users.cpu().numpy(), data.items.cpu().numpy())
        items = items + self.n_users
        src, dst = sort_edges_by_dst(np.concatenate([users, items]), np.concatenate([items, users]))
        # unit values on mirrored edges: the backward runs on the same edges
        self.graph = message_graph(src, dst, self.N, self.device, symmetric=True)
        dev = self.device
        self.id_embedding = nn.Parameter(torch.empty(self.N, self.dim_x, device=dev))
        if self.v_feat is not None:
            self.v_gcn = _Tower(self.n_users, self.v_feat.shape[1], self.dim_latent_v, self.dim_x, dev)
        if self.t_feat is not None:
            self.t_gcn = _Tower(self.n_users, self.t_feat.shape[1], None, self.dim_x, dev)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        self.id_embedding.copy_(xavier_normal(self.id_embedding.shape, generator))
        for name in ("v_gcn", "t_gcn"):
            if hasattr(self, name):
                getattr(self, name).init_params(generator)

    def forward(self):
        towers = [(self.v_gcn, self.v_feat)] if self.v_feat is not None else []
        towers += [(self.t_gcn, self.t_feat)] if self.t_feat is not None else []
        reps = [tower(feats, self.id_embedding, self.graph) for tower, feats in towers]
        return sum(reps[1:], reps[0]) / len(reps)

    def loss(self, state, batch, generator=None):
        users, pos, neg, w = batch["users"], batch["pos"], batch["neg"], batch["weight"]
        rows = batch.get("rows")
        out = self.forward()
        u, p_e, n_e = out[users], out[pos + self.n_users], out[neg + self.n_users]
        bpr = bpr_loss((u * p_e).sum(1), (u * n_e).sum(1), w, gamma=1e-12, rows=rows)
        ids = self.id_embedding
        sq = lambda x: row_mean(x**2, rows)
        reg = sq(ids[users]) + sq(ids[pos + self.n_users]) + sq(ids[neg + self.n_users])
        if self.v_feat is not None:
            reg = reg + table_share((self.v_gcn.preference**2).mean(), rows)
        total = bpr + self.reg_weight * reg
        return total, (total,)

    def full_embeddings(self, state):
        out = self.forward()
        return out[: self.n_users], out[self.n_users :]
