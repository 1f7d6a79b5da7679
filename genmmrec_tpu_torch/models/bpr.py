"""BPR matrix factorization (counterpart of ``genmmrec_tpu/models/bpr.py``):
xavier-normal user and item tables, pairwise BPR loss plus the embedding
regularizer, full-catalog scores ``U @ Iᵀ``."""

from __future__ import annotations

import torch
from torch import nn

from genmmrec_tpu_torch.common.init import xavier_normal
from genmmrec_tpu_torch.common.losses import bpr_loss, emb_loss
from genmmrec_tpu_torch.models.base import RecModel


class BPR(RecModel):
    is_multimodal = False

    def __init__(self, config, data):
        super().__init__(config, data)
        self.embedding_size = int(config["embedding_size"])
        self.reg_weight = float(config["reg_weight"])
        self.user_emb = nn.Parameter(torch.empty(self.n_users, self.embedding_size, device=self.device))
        self.item_emb = nn.Parameter(torch.empty(self.n_items, self.embedding_size, device=self.device))

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        self.user_emb.copy_(xavier_normal(self.user_emb.shape, generator))
        self.item_emb.copy_(xavier_normal(self.item_emb.shape, generator))

    def loss(self, state, batch, generator=None):
        u = self.user_emb[batch["users"]]
        pos = self.item_emb[batch["pos"]]
        neg = self.item_emb[batch["neg"]]
        rows = batch.get("rows")
        mf = bpr_loss((u * pos).sum(dim=1), (u * neg).sum(dim=1), batch["weight"], rows=rows)
        total = mf + self.reg_weight * emb_loss(u, pos, neg, rows=rows)
        return total, (total,)

    def full_embeddings(self, state):
        return self.user_emb, self.item_emb
