"""ItemKNNCBF: non-parametric content-based item KNN (counterpart of
``genmmrec_tpu/models/itemknncbf.py``): the shrunk cosine similarity
``ij / (‖i‖‖j‖ + shrink)`` of the raw item features, each row's top
``knn_k`` kept, and ``scores = R @ S`` computed once at construction, R
the train interactions with repeated pairs summed. Trains nothing
(``req_training: False``)."""

from __future__ import annotations

import torch
from torch import nn

from genmmrec_tpu_torch.models.base import RecModel, scalar
from genmmrec_tpu_torch.ops.precision import full_precision_matmuls
from genmmrec_tpu_torch.ops.topk import grouped_topk

# rows of one similarity block, as the JAX package blocks it
SIM_BLOCK = 4096


class ItemKNNCBF(RecModel):
    def __init__(self, config, data):
        super().__init__(config, data)
        self.knn_k = scalar(config["knn_k"], int)
        self.shrink = scalar(config["shrink"] or 0.0)
        self.dummy_embeddings = nn.Parameter(torch.empty(2, device=self.device))
        self.scores_matrix = self._scores_matrix(data)

    @torch.no_grad()
    def init_params(self, generator=None) -> None:
        self.dummy_embeddings.fill_(0.5)

    @torch.no_grad()
    def similarity(self, lo: int, hi: int) -> torch.Tensor:
        """(hi - lo, n_items) shrunk cosine similarities of items lo..hi-1
        to every item: a float32 product, no TF32."""
        full_precision_matmuls()
        feats = self.item_raw_features.to(torch.float32)
        norms = torch.linalg.vector_norm(feats, dim=1, keepdim=True)
        return (feats[lo:hi] @ feats.T) / (norms[lo:hi] * norms.T + self.shrink)

    @torch.no_grad()
    def _scores_matrix(self, data) -> torch.Tensor:
        """R @ S with S the dense (n_items, n_items) similarity holding each
        row's top ``knn_k`` (K3; the JAX package's ``argpartition`` keeps the
        same set where the values are distinct)."""
        n = self.n_items
        k = min(self.knn_k, n)
        S = torch.zeros(n, n, device=self.device)
        for lo in range(0, n, SIM_BLOCK):
            hi = min(lo + SIM_BLOCK, n)
            vals, cols = grouped_topk(self.similarity(lo, hi), k)
            S[lo:hi].scatter_(1, cols, vals)
        R = torch.zeros(self.n_users, n, device=self.device)
        R.index_put_((data.users, data.items), torch.ones(data.n_inter, device=self.device), accumulate=True)
        return R @ S

    def loss(self, state, batch, generator=None):
        zero = (self.dummy_embeddings * 0.0).sum()
        return zero, (zero,)

    def scores(self, state, users) -> torch.Tensor:
        return self.scores_matrix[users]
