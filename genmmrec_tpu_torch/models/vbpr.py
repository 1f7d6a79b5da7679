"""VBPR (counterpart of ``genmmrec_tpu/models/vbpr.py``): a user embedding
of width 2·d against the item side [id embedding (d) ; a linear projection
of the raw text and vision features (d)]; BPR plus the embedding
regularizer; full-catalog scores ``U @ Iᵀ``."""

from __future__ import annotations

import torch
from torch import nn

from genmmrec_tpu_torch.common.init import init_linear, xavier_normal, xavier_uniform
from genmmrec_tpu_torch.common.losses import bpr_loss, emb_loss
from genmmrec_tpu_torch.models.base import RecModel, scalar


class VBPR(RecModel):
    def __init__(self, config, data):
        super().__init__(config, data)
        self.embedding_size = scalar(config["embedding_size"], int)
        self.reg_weight = scalar(config["reg_weight"])
        d, dev = self.embedding_size, self.device
        # the concatenation, made once: every batch projects every item
        self.raw_features = self.item_raw_features
        self.u_embedding = nn.Parameter(torch.empty(self.n_users, 2 * d, device=dev))
        self.i_embedding = nn.Parameter(torch.empty(self.n_items, d, device=dev))
        self.item_linear = nn.Linear(self.raw_features.shape[1], d, device=dev)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        self.u_embedding.copy_(xavier_uniform(self.u_embedding.shape, generator))
        self.i_embedding.copy_(xavier_uniform(self.i_embedding.shape, generator))
        # the reference re-initializes the layer xavier-normal with a zero bias
        init_linear(self.item_linear, generator, init=xavier_normal, zero_bias=True)

    def _item_embeddings(self) -> torch.Tensor:
        return torch.cat([self.i_embedding, self.item_linear(self.raw_features)], dim=-1)

    def loss(self, state, batch, generator=None):
        item_emb = self._item_embeddings()
        u = self.u_embedding[batch["users"]]
        pos, neg = item_emb[batch["pos"]], item_emb[batch["neg"]]
        rows = batch.get("rows")
        mf = bpr_loss((u * pos).sum(dim=1), (u * neg).sum(dim=1), batch["weight"], rows=rows)
        total = mf + self.reg_weight * emb_loss(u, pos, neg, rows=rows)
        return total, (total,)

    def full_embeddings(self, state):
        return self.u_embedding, self._item_embeddings()
