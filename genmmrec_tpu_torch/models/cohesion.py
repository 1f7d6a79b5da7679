"""COHESION: composite GCN towers with dual-stage fusion and an adaptive
modality weight (counterpart of ``genmmrec_tpu/models/cohesion.py``).

- Three towers (id, visual, text) over the symmetric degree-normalized
  user-item graph (K1 through ``spmm``; the per-epoch pruning of FREEDOM,
  ``SampledUIGraph``): MLP-projected features RMS-combined with the id
  feature (``sqrt(|id² + f²| / 2 + 1e-8)``), the user preference on top,
  ``num_layer`` hops each re-weighted by its cosine to the ego layer. The id
  tower is computed without gradient (the reference reads ``id_rep.data``).
- The representation is ``cat(id, v, t)`` (3·64); the users add DualGNN's
  user co-occurrence aggregation (the shared ``build_user_graph``), the
  items the mixed KNN item graph's hops (``mixed_knn_graph``).
- Adaptive optimization: the softmax of each modality segment's score
  difference, detached, re-weights the three segments of the BPR scores.
- Loss: -mean(log₂ σ) plus the preference and ``weight_u`` regularizer.

The evaluation reads the state's graph, pruned or not (``pre_epoch`` keeps
``1 - dropout`` of the pairs by Gumbel top-k in proportion to their degree
weights; ``dropout: 0``, baby's value, keeps all and draws nothing).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from genmmrec_tpu_torch.common.init import init_linear, xavier_normal
from genmmrec_tpu_torch.common.losses import bpr_loss, row_mean, table_share
from genmmrec_tpu_torch.common.norm import l2n
from genmmrec_tpu_torch.models.base import RecModel, scalar
from genmmrec_tpu_torch.models.dualgnn import build_user_graph
from genmmrec_tpu_torch.ops.graph import SampledUIGraph, mixed_knn_graph, spmm, unique_ui_pairs


class _Tower(nn.Module):
    def __init__(self, n_users: int, feat_dim: int, d: int, device):
        super().__init__()
        self.preference = nn.Parameter(torch.empty(n_users, d, device=device))
        self.mlp = nn.Linear(feat_dim, 4 * d, device=device)
        self.mlp1 = nn.Linear(4 * d, d, device=device)

    @torch.no_grad()
    def init_params(self, generator):
        self.preference.copy_(xavier_normal(self.preference.shape, generator))
        init_linear(self.mlp, generator, zero_bias=True)
        init_linear(self.mlp1, generator, zero_bias=True)

    def forward(self, feats, id_feat, adj, num_layer: int):
        tf = self.mlp1(F.leaky_relu(self.mlp(feats), 0.01))
        tf = torch.sqrt(torch.abs((id_feat * id_feat + tf * tf) / 2.0) + 1e-8)
        ego = acc = cur = l2n(torch.cat([self.preference, tf]))
        for _ in range(num_layer):
            cur = spmm(adj, cur)
            cur = (l2n(cur) * l2n(ego)).sum(-1, keepdim=True) * cur
            acc = acc + cur
        return acc


class COHESION(RecModel):
    def __init__(self, config, data):
        super().__init__(config, data)
        self.n_layers = scalar(config["n_mm_layers"], int)
        self.knn_k = scalar(config["knn_k"], int)
        self.mm_image_weight = scalar(config["mm_image_weight"])
        self.dropout = scalar(config["dropout"])
        self.num_layer = scalar(config["num_layer"] or 2, int)
        self.reg_weight = scalar(config["reg_weight"])
        self.dim_latent = d = 64
        self.k = 40
        dev = self.device
        users, items = unique_ui_pairs(data.users.cpu().numpy(), data.items.cpu().numpy())
        self.ui = SampledUIGraph(users, items, self.n_users, self.n_items, dev)
        self.mm_adj = mixed_knn_graph(self.v_feat, self.t_feat, self.knn_k, self.mm_image_weight)
        self.user_graph = build_user_graph(config, users, items, self.n_users, self.n_items, self.k, dev)
        self.id_feat = nn.Parameter(torch.empty(self.n_items, d, device=dev))
        self.id_gcn = _Tower(self.n_users, d, d, dev)
        self.v_gcn = _Tower(self.n_users, self.v_feat.shape[1], d, dev)
        self.t_gcn = _Tower(self.n_users, self.t_feat.shape[1], d, dev)
        self.weight_u = nn.Parameter(torch.empty(self.n_users, 2, 1, device=dev))

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        self.id_feat.copy_(xavier_normal(self.id_feat.shape, generator))
        for tower in (self.id_gcn, self.v_gcn, self.t_gcn):
            tower.init_params(generator)
        self.weight_u.copy_(torch.softmax(xavier_normal(self.weight_u.shape, generator), dim=1))

    def init_state(self, generator=None) -> dict:
        return {"masked_vals": self.ui.values()}

    @torch.no_grad()
    def pre_epoch(self, state, generator, epoch: int, uniform=None) -> dict:
        """Keep ``1 - dropout`` of the user-item pairs for this epoch, in
        proportion to their degree weights. ``uniform`` gives the (n_edges,)
        U[0, 1) draw in place of the generator's."""
        if self.dropout <= 0.0:
            return self.init_state()
        n_keep = int(self.ui.n_edges * (1.0 - self.dropout))
        if uniform is None:
            uniform = torch.rand(self.ui.n_edges, generator=generator, device=self.device)
        return {"masked_vals": self.ui.values(self.ui.sample_keep(n_keep, uniform))}

    def forward(self, state):
        adj = self.ui.graph(state["masked_vals"])
        with torch.no_grad():
            id_rep = self.id_gcn(self.id_feat, self.id_feat, adj, self.num_layer)
        v_rep = self.v_gcn(self.v_feat, self.id_feat, adj, self.num_layer)
        t_rep = self.t_gcn(self.t_feat, self.id_feat, adj, self.num_layer)
        U = self.n_users
        user_rep = torch.cat([id_rep[:U], v_rep[:U], t_rep[:U]], dim=1)
        item_rep = torch.cat([id_rep[U:], v_rep[U:], t_rep[U:]], dim=1)
        h_i = item_rep
        for _ in range(self.n_layers):
            h_i = spmm(self.mm_adj, h_i)
        return user_rep + spmm(self.user_graph, user_rep), item_rep + h_i

    def _adaptive_scores(self, u, p_e, n_e):
        d = self.dim_latent
        pos_seg = (u * p_e).reshape(-1, 3, d).sum(-1)
        neg_seg = (u * n_e).reshape(-1, 3, d).sum(-1)
        indicator = 1.0 - torch.softmax(pos_seg - neg_seg, dim=-1).detach()
        wgt = indicator.repeat_interleave(d, dim=1)
        return (u * p_e * wgt).sum(1), (u * n_e * wgt).sum(1)

    def loss(self, state, batch, generator=None):
        users, pos, neg, w = batch["users"], batch["pos"], batch["neg"], batch["weight"]
        rows = batch.get("rows")
        user_rep, item_rep = self.forward(state)
        pos_s, neg_s = self._adaptive_scores(user_rep[users], item_rep[pos], item_rep[neg])
        bpr = bpr_loss(pos_s, neg_s, w, gamma=1e-12, rows=rows) / math.log(2.0)
        reg = (
            row_mean(self.v_gcn.preference[users] ** 2, rows) + row_mean(self.t_gcn.preference[users] ** 2, rows)
            + table_share((self.weight_u**2).mean(), rows)
        )
        total = bpr + self.reg_weight * reg
        return total, (total,)

    def full_embeddings(self, state):
        return self.forward(state)
