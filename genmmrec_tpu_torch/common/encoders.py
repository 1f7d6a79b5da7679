"""Shared LightGCN encoder (counterpart of
``genmmrec_tpu/common/encoders.py``), used by SELFCFED_LGN: embedding tables
propagated through the normalized adjacency, the layers averaged; sparse
edge dropout is value masking."""

from __future__ import annotations

import torch
from torch import nn

from genmmrec_tpu_torch.common.init import xavier_uniform
from genmmrec_tpu_torch.models.base import scalar
from genmmrec_tpu_torch.ops.graph import bipartite_norm_adj, edge_dropout, spmm


class LightGCNEncoder(nn.Module):
    def __init__(self, config, data, n_layers_key: str = "n_layers"):
        super().__init__()
        self.n_users = data.n_users
        self.n_items = data.n_items
        self.latent_size = scalar(config["embedding_size"], int)
        self.n_layers = scalar(config[n_layers_key] or 3, int)
        self.norm_adj = bipartite_norm_adj(
            data.users.cpu().numpy(), data.items.cpu().numpy(), self.n_users, self.n_items, data.device
        )
        self.user_emb = nn.Parameter(torch.empty(self.n_users, self.latent_size, device=data.device))
        self.item_emb = nn.Parameter(torch.empty(self.n_items, self.latent_size, device=data.device))

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        self.user_emb.copy_(xavier_uniform(self.user_emb.shape, generator))
        self.item_emb.copy_(xavier_uniform(self.item_emb.shape, generator))

    def propagate(self, generator=None, keep_prob: float = 1.0, keep=None):
        """(user, item) embeddings. With ``keep_prob < 1`` and a generator or
        an injected ``keep`` mask, the adjacency's edges are dropped first."""
        adj = self.norm_adj
        if (generator is not None or keep is not None) and keep_prob < 1.0:
            adj = edge_dropout(adj, keep_prob, generator=generator, keep=keep)
        x = torch.cat([self.user_emb, self.item_emb])
        acc = x
        for _ in range(self.n_layers):
            x = spmm(adj, x)
            acc = acc + x
        out = acc / (self.n_layers + 1)
        return out[: self.n_users], out[self.n_users :]
