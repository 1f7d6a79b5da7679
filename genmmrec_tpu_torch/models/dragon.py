"""DRAGON: DualGNN's towers and user graph with a frozen item graph
(counterpart of ``genmmrec_tpu/models/dragon.py``).

DualGNN's modal towers (K1 through ``propagate``) and its user
co-occurrence graph, plus the mixed ``binary_row`` KNN item graph
(``mixed_knn_graph``, K3 at set-up) whose ``n_mm_layers`` hops (K1) are
added to the item side, and the ``cat`` construction: the representation
concatenates the two towers (2·d), each user's halves scaled by its
softmax-initialized ``weight_u``. ``weight_i`` is a parameter that the loss
does not read, as in the reference.
"""

from __future__ import annotations

import torch

from genmmrec_tpu_torch.common.losses import row_mean, table_share
from genmmrec_tpu_torch.models.base import scalar
from genmmrec_tpu_torch.models.dualgnn import DualGNN
from genmmrec_tpu_torch.ops.graph import mixed_knn_graph, spmm


class DRAGON(DualGNN):
    def __init__(self, config, data):
        super().__init__(config, data)
        self.knn_k = scalar(config["knn_k"] or 10, int)
        self.mm_image_weight = scalar(config["mm_image_weight"] or 0.1)
        self.n_mm_layers = scalar(config["n_mm_layers"] or 1, int)
        self.mm_adj = mixed_knn_graph(self.v_feat, self.t_feat, self.knn_k, self.mm_image_weight)

    def forward(self):
        v_rep, t_rep = self._tower("v", self.v_feat), self._tower("t", self.t_feat)
        U = self.n_users
        wu = self.weight_u[:, :, 0]  # (U, 2)
        user_rep = torch.cat([v_rep[:U] * wu[:, :1], t_rep[:U] * wu[:, 1:]], dim=1)
        item_rep = torch.cat([v_rep[U:], t_rep[U:]], dim=1)
        h = item_rep
        for _ in range(self.n_mm_layers):
            h = spmm(self.mm_adj, h)
        return torch.cat([user_rep + spmm(self.user_graph, user_rep), item_rep + h])

    def loss(self, state, batch, generator=None):
        users, pos, neg, w = batch["users"], batch["pos"], batch["neg"], batch["weight"]
        rows = batch.get("rows")
        out = self.forward()
        bpr = self._bpr_log2(out[users], out[pos + self.n_users], out[neg + self.n_users], w, rows)
        reg = (
            row_mean(self.v_preference[users] ** 2, rows) + row_mean(self.t_preference[users] ** 2, rows)
            + table_share((self.weight_u**2).mean(), rows)
        )
        total = bpr + self.reg_weight * reg
        return total, (total,)
