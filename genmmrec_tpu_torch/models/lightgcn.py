"""LightGCN (counterpart of ``genmmrec_tpu/models/lightgcn.py``):
xavier-uniform embedding tables, ``n_layers`` propagations through the
normalized adjacency with the layers averaged, BPR plus the regularizer on
the ego embeddings. The propagation is ``ops.graph.spmm`` over the whole
graph at every step, as in the reference: K1 on a small graph, K2 on one
whose operand outgrows the L2 (Amazon-elec)."""

from __future__ import annotations

import torch
from torch import nn

from genmmrec_tpu_torch.common.init import xavier_uniform
from genmmrec_tpu_torch.common.losses import bpr_loss, emb_loss
from genmmrec_tpu_torch.models.base import RecModel, scalar
from genmmrec_tpu_torch.ops.graph import bipartite_norm_adj, spmm


class LightGCN(RecModel):
    is_multimodal = False

    def __init__(self, config, data):
        super().__init__(config, data)
        self.latent_dim = scalar(config["embedding_size"], int)
        self.n_layers = scalar(config["n_layers"], int)
        self.reg_weight = scalar(config["reg_weight"])
        self.norm_adj = bipartite_norm_adj(
            data.users.cpu().numpy(), data.items.cpu().numpy(), self.n_users, self.n_items, self.device
        )
        self.user_emb = nn.Parameter(torch.empty(self.n_users, self.latent_dim, device=self.device))
        self.item_emb = nn.Parameter(torch.empty(self.n_items, self.latent_dim, device=self.device))

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        self.user_emb.copy_(xavier_uniform(self.user_emb.shape, generator))
        self.item_emb.copy_(xavier_uniform(self.item_emb.shape, generator))

    def propagate(self):
        x = torch.cat([self.user_emb, self.item_emb])
        layers = [x]
        for _ in range(self.n_layers):
            x = spmm(self.norm_adj, x)
            layers.append(x)
        out = torch.stack(layers, dim=1).mean(dim=1)
        return out[: self.n_users], out[self.n_users :]

    def loss(self, state, batch, generator=None):
        u_all, i_all = self.propagate()
        users, pos, neg = batch["users"], batch["pos"], batch["neg"]
        u = u_all[users]
        rows = batch.get("rows")
        mf = bpr_loss((u * i_all[pos]).sum(dim=1), (u * i_all[neg]).sum(dim=1), batch["weight"], rows=rows)
        reg = emb_loss(self.user_emb[users], self.item_emb[pos], self.item_emb[neg], rows=rows)
        total = mf + self.reg_weight * reg
        return total, (total,)

    def full_embeddings(self, state):
        return self.propagate()
