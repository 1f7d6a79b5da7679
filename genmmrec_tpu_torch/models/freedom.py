"""FREEDOM: a frozen multimodal item graph and a denoised user-item graph
(counterpart of ``genmmrec_tpu/models/freedom.py``):

- the item graph, built once: each modality's KNN graph (K3 on the
  feature similarity, unit values normalized by the out-degrees), the image
  graph weighted by ``mm_image_weight`` and the text graph by the rest,
  summed as an edge-list union (a pair in both stays two edges);
- per epoch, degree-sensitive edge sampling of the user-item graph
  (``pre_epoch``): ``1 - dropout`` of the unique pairs kept by Gumbel top-k
  in proportion to their degree weights, re-normalized, both directions;
- forward: ``n_mm_layers`` item-graph hops on the item-id embedding, then
  ``n_ui_layers`` hops of the symmetric user-item graph (K1, whose backward
  is K1 on the cotangent) averaged over the layers, the items plus the
  item-graph output; the evaluation takes the unpruned graph;
- loss: BPR plus ``reg_weight`` times the BPR terms of the projected raw
  features as item embeddings.
"""

from __future__ import annotations

import torch
from torch import nn

from genmmrec_tpu_torch.common.init import init_linear, xavier_normal, xavier_uniform
from genmmrec_tpu_torch.common.losses import bpr_loss
from genmmrec_tpu_torch.models.base import RecModel, scalar
from genmmrec_tpu_torch.ops.graph import SampledUIGraph, mixed_knn_graph, spmm


class FREEDOM(RecModel):
    def __init__(self, config, data):
        super().__init__(config, data)
        d = self.embedding_dim = scalar(config["embedding_size"], int)
        self.feat_embed_dim = scalar(config["feat_embed_dim"], int)
        self.knn_k = scalar(config["knn_k"], int)
        self.n_layers = scalar(config["n_mm_layers"], int)
        self.n_ui_layers = scalar(config["n_ui_layers"], int)
        self.reg_weight = scalar(config["reg_weight"])
        self.mm_image_weight = scalar(config["mm_image_weight"])
        self.dropout = scalar(config["dropout"])
        dev = self.device
        self.ui = SampledUIGraph(data.users.cpu().numpy(), data.items.cpu().numpy(), self.n_users, self.n_items, dev)
        self.mm_adj = mixed_knn_graph(self.v_feat, self.t_feat, self.knn_k, self.mm_image_weight)
        self.user_embedding = nn.Parameter(torch.empty(self.n_users, d, device=dev))
        self.item_id_embedding = nn.Parameter(torch.empty(self.n_items, d, device=dev))
        if self.v_feat is not None:
            self.image_trs = nn.Linear(self.v_feat.shape[1], self.feat_embed_dim, device=dev)
        if self.t_feat is not None:
            self.text_trs = nn.Linear(self.t_feat.shape[1], self.feat_embed_dim, device=dev)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        self.user_embedding.copy_(xavier_uniform(self.user_embedding.shape, generator))
        self.item_id_embedding.copy_(xavier_uniform(self.item_id_embedding.shape, generator))
        for name in ("image_trs", "text_trs"):
            if hasattr(self, name):
                init_linear(getattr(self, name), generator, init=xavier_normal)

    def init_state(self, generator=None) -> dict:
        return {"masked_vals": self.ui.values()}

    @torch.no_grad()
    def pre_epoch(self, state, generator, epoch: int, uniform=None) -> dict:
        """Keep ``1 - dropout`` of the user-item pairs for this epoch, in
        proportion to their degree weights. ``uniform`` gives the (n_edges,)
        U[0, 1) draw in place of the generator's."""
        if self.dropout <= 0.0:
            return {"masked_vals": self.ui.values()}
        n_keep = int(self.ui.n_edges * (1.0 - self.dropout))
        if uniform is None:
            uniform = torch.rand(self.ui.n_edges, generator=generator, device=self.device)
        return {"masked_vals": self.ui.values(self.ui.sample_keep(n_keep, uniform))}

    def propagate(self, vals: torch.Tensor):
        h = self.item_id_embedding
        for _ in range(self.n_layers):
            h = spmm(self.mm_adj, h)
        adj = self.ui.graph(vals)
        x = torch.cat([self.user_embedding, self.item_id_embedding])
        layers = [x]
        for _ in range(self.n_ui_layers):
            x = spmm(adj, x)
            layers.append(x)
        out = torch.stack(layers, dim=1).mean(dim=1)
        return out[: self.n_users], out[self.n_users :] + h

    def loss(self, state, batch, generator=None):
        users, pos, neg, w = batch["users"], batch["pos"], batch["neg"], batch["weight"]
        ua, ia = self.propagate(state["masked_vals"])
        u = ua[users]
        rows = batch.get("rows")
        bpr = lambda items: bpr_loss((u * items[pos]).sum(dim=1), (u * items[neg]).sum(dim=1), w, gamma=0.0, rows=rows)
        modal = 0.0
        for trs, feats in (("text_trs", self.t_feat), ("image_trs", self.v_feat)):
            if feats is not None:
                modal = modal + bpr(getattr(self, trs)(feats))
        total = bpr(ia) + self.reg_weight * modal
        return total, (total,)

    def full_embeddings(self, state):
        return self.propagate(self.ui.values())
