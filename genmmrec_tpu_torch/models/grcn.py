"""GRCN: graph-refined convolutional network (counterpart of
``genmmrec_tpu/models/grcn.py``).

- A content tower per modality: the MLP-projected features and a user
  preference matrix, dot-product attention with the softmax over each
  destination's edges (``segment_softmax``), propagated by ``add`` (K1)
  with the attention as edge weights. The routing passes run over the
  directed user → item edges, as the JAX package does: only items receive
  there, so the preference rows of ``x_hat`` are zero and the routing only
  normalizes the preference. The last pass, over the symmetric edges, also
  gives each edge's attention ``alpha``.
- The edge weights of the id tower: each modality's ``alpha`` times the
  learned ``model_specific_conf`` of the edge's user-side node (``conf[src]``
  on the user → item half, ``conf[dst]`` on the other, built in that
  concatenated layout and realigned to the dst-sorted edges by ``_perm_s``),
  the maximum over the modalities, through a relu. The gradient flows into
  those weights: the first path of the port on which K1's values carry one
  (``segment._Spmm``'s vals-gradient).
- The per-edge gathers are ``index_select``s: their backward is one
  scatter-add (``index_add_``), where an indexing's backward sorts the
  indices first.
- The id tower: two ``add`` hops over those weights, ``x + x̂₁ + x̂₂``;
  the representation is ``cat(id, content)``; BPR plus the id and
  preference regularizer.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from genmmrec_tpu_torch.common.init import init_linear, xavier_normal
from genmmrec_tpu_torch.common.losses import bpr_loss, row_mean, table_share
from genmmrec_tpu_torch.common.norm import l2n
from genmmrec_tpu_torch.models.base import RecModel, scalar
from genmmrec_tpu_torch.ops.graph import unique_ui_pairs
from genmmrec_tpu_torch.ops.mp import message_graph, propagate, segment_softmax, sort_edges_by_dst


class GRCN(RecModel):
    def __init__(self, config, data):
        super().__init__(config, data)
        self.dim_x = scalar(config["embedding_size"], int)
        self.dim_C = scalar(config["latent_embedding"] or 64, int)
        self.num_routing = scalar(config["n_layers"], int)
        self.reg_weight = scalar(config["reg_weight"])
        self.N = self.n_users + self.n_items
        dev = self.device
        users, items = unique_ui_pairs(data.users.cpu().numpy(), data.items.cpu().numpy())
        items = items + self.n_users
        # the pairs' two ends in their (user, item) order: the layout of conf
        self.src_d = torch.as_tensor(users, device=dev)
        self.dst_d = torch.as_tensor(items, device=dev)
        self.directed = message_graph(*sort_edges_by_dst(users, items), self.N, dev)
        src_s, dst_s = np.concatenate([users, items]), np.concatenate([items, users])
        order = np.argsort(dst_s, kind="stable")
        self._perm_s = torch.as_tensor(order, device=dev)
        self.graph = message_graph(src_s[order], dst_s[order], self.N, dev)
        self.id_embedding = nn.Parameter(torch.empty(self.N, self.dim_x, device=dev))
        self.v_preference = nn.Parameter(torch.empty(self.n_users, self.dim_C, device=dev))
        self.v_mlp = nn.Linear(self.v_feat.shape[1], self.dim_C, device=dev)
        self.t_preference = nn.Parameter(torch.empty(self.n_users, self.dim_C, device=dev))
        self.t_mlp = nn.Linear(self.t_feat.shape[1], self.dim_C, device=dev)
        self.model_specific_conf = nn.Parameter(torch.empty(self.N, 2, device=dev))

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        for p in (self.id_embedding, self.v_preference, self.t_preference, self.model_specific_conf):
            p.copy_(xavier_normal(p.shape, generator))
        init_linear(self.v_mlp, generator, zero_bias=True)
        init_linear(self.t_mlp, generator, zero_bias=True)

    def _gat_pass(self, x, g):
        """Dot-product attention propagation over ``g``: (out, alpha)."""
        scores = (x.index_select(0, g.cols) * x.index_select(0, g.rows)).sum(-1)
        alpha = segment_softmax(scores, g.rows, self.N)
        return propagate(x, g, "add", edge_weight=alpha), alpha

    def _cgcn(self, pref, mlp, feats):
        features = l2n(F.leaky_relu(mlp(feats), 0.01))
        preference = l2n(pref)
        for _ in range(self.num_routing):
            x_hat, _ = self._gat_pass(torch.cat([preference, features]), self.directed)
            preference = l2n(preference + x_hat[: self.n_users])
        x = torch.cat([preference, features])
        x_hat, alpha = self._gat_pass(x, self.graph)
        return x + x_hat, alpha[:, None]

    def forward(self):
        v_rep, w_v = self._cgcn(self.v_preference, self.v_mlp, self.v_feat)
        t_rep, w_t = self._cgcn(self.t_preference, self.t_mlp, self.t_feat)
        conf = self.model_specific_conf
        conf = torch.cat([conf.index_select(0, self.src_d), conf.index_select(0, self.dst_d)]).index_select(0, self._perm_s)
        weight = F.relu(torch.amax(torch.cat([w_v, w_t], dim=1) * conf, dim=1))
        x = l2n(self.id_embedding)
        x1 = propagate(x, self.graph, "add", edge_weight=weight)
        x2 = propagate(x1, self.graph, "add", edge_weight=weight)
        return torch.cat([x + x1 + x2, v_rep, t_rep], dim=1)

    def loss(self, state, batch, generator=None):
        users, pos, neg, w = batch["users"], batch["pos"], batch["neg"], batch["weight"]
        rows = batch.get("rows")
        out = self.forward()
        u, p_e, n_e = out[users], out[pos + self.n_users], out[neg + self.n_users]
        bpr = bpr_loss((u * p_e).sum(1), (u * n_e).sum(1), w, gamma=1e-12, rows=rows)
        ids = self.id_embedding
        sq = lambda x: row_mean(x**2, rows)
        reg = (
            sq(ids[users]) + sq(ids[pos + self.n_users]) + sq(ids[neg + self.n_users])
            + table_share((self.v_preference**2).mean(), rows) + sq(self.v_preference[users])
            + sq(self.t_preference[users])
        )
        total = bpr + self.reg_weight * reg
        return total, (total,)

    def full_embeddings(self, state):
        out = self.forward()
        return out[: self.n_users], out[self.n_users :]
