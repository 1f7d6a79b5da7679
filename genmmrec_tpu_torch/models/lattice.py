"""LATTICE: a learned item-item latent graph (counterpart of
``genmmrec_tpu/models/lattice.py``).

- The frozen original graphs: each modality's dense KNN plane of its raw
  feature similarity (``knn_graph_dense``: K3's top-k at set-up, "sym").
- The learned graph, rebuilt with gradients at every batch and every
  evaluation: each modality's projected features, their similarity plane
  (``build_sim``), K3's top-``knn_k`` of the detached plane with the values
  gathered from the plane that carries the gradient (``dense_topk_plane``),
  the two mixed by the softmax of ``modal_weight``, "sym"-normalized, then
  blended with the mixed original graphs by ``lambda_coeff``. At baby each
  plane is 7,050² float32 (199 MB).
- Items propagate ``n_layers`` times over that dense graph (a dense
  product); users and items through ``len(weight_size)`` LightGCN layers
  over D^-1(A + I) (not symmetric: K1's backward runs over the transposed
  CSR), or not at all with ``cf_model: mf``; the item side adds the
  row-normalized item-graph output.
- Loss: BPR plus ``reg_weight`` times the batch-scaled L2.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from genmmrec_tpu_torch.common.init import init_linear, xavier_normal, xavier_uniform
from genmmrec_tpu_torch.common.losses import bpr_loss
from genmmrec_tpu_torch.models.base import RecModel, scalar
from genmmrec_tpu_torch.models.mgcn import batch_l2
from genmmrec_tpu_torch.ops.graph import (
    _from_host, build_sim, dense_topk_plane, knn_graph_dense, layer_mean, norm_laplacian_dense,
)
from genmmrec_tpu_torch.ops.precision import full_precision_matmuls


def rw_plus_eye_adj(users: np.ndarray, items: np.ndarray, n_users: int, n_items: int, device):
    """D^-1(A + I): every train interaction both ways plus a self loop on
    every node, each edge over its row's edge count; stably row-sorted, on
    ``device``. Built on the host with the JAX package's numpy code."""
    N = n_users + n_items
    users, items = users.astype(np.int64), items.astype(np.int64)
    rows = np.concatenate([users, items + n_users, np.arange(N)])
    cols = np.concatenate([items + n_users, users, np.arange(N)])
    deg = np.bincount(rows, minlength=N).astype(np.float64)
    dinv = np.where(deg > 0, 1.0 / np.maximum(deg, 1.0), 0.0)
    return _from_host(rows, cols, dinv[rows].astype(np.float32), N, N, device, symmetric=False)


class LATTICE(RecModel):
    def __init__(self, config, data):
        super().__init__(config, data)
        d = self.embedding_dim = scalar(config["embedding_size"], int)
        self.feat_embed_dim = scalar(config["feat_embed_dim"], int)
        self.knn_k = scalar(config["knn_k"], int)
        self.lambda_coeff = scalar(config["lambda_coeff"])
        self.cf_model = str(config["cf_model"] or "lightgcn")
        self.n_layers = scalar(config["n_layers"], int)
        self.reg_weight = scalar(config["reg_weight"])
        self.n_ui_layers = len(config["weight_size"] or [64, 64])
        self.batch_size = int(config["train_batch_size"])
        dev = self.device
        full_precision_matmuls()
        users, items = data.users.cpu().numpy(), data.items.cpu().numpy()
        self.norm_adj = rw_plus_eye_adj(users, items, self.n_users, self.n_items, dev)
        original = lambda f: None if f is None else knn_graph_dense(build_sim(f), self.knn_k)
        self.image_original_adj = original(self.v_feat)
        self.text_original_adj = original(self.t_feat)
        self.user_embedding = nn.Parameter(torch.empty(self.n_users, d, device=dev))
        self.item_id_embedding = nn.Parameter(torch.empty(self.n_items, d, device=dev))
        self.modal_weight = nn.Parameter(torch.full((2,), 0.5, device=dev))
        if self.v_feat is not None:
            self.image_trs = nn.Linear(self.v_feat.shape[1], self.feat_embed_dim, device=dev)
        if self.t_feat is not None:
            self.text_trs = nn.Linear(self.t_feat.shape[1], self.feat_embed_dim, device=dev)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        self.user_embedding.copy_(xavier_uniform(self.user_embedding.shape, generator))
        self.item_id_embedding.copy_(xavier_uniform(self.item_id_embedding.shape, generator))
        self.modal_weight.fill_(0.5)
        for name in ("image_trs", "text_trs"):
            if hasattr(self, name):
                init_linear(getattr(self, name), generator, init=xavier_normal, zero_bias=True)

    def learned_item_adj(self) -> torch.Tensor:
        """The (n_items, n_items) item graph of this step, with gradients
        into the projections and ``modal_weight``."""
        weight = torch.softmax(self.modal_weight, dim=0)
        learned = original = None
        for trs, feats, orig in (("image_trs", self.v_feat, self.image_original_adj),
                                 ("text_trs", self.t_feat, self.text_original_adj)):
            if feats is None:
                continue
            adj = dense_topk_plane(build_sim(getattr(self, trs)(feats)), self.knn_k)
            if learned is None:
                learned, original = adj, orig
            else:
                learned = weight[0] * learned + weight[1] * adj
                original = weight[0] * self.image_original_adj + weight[1] * self.text_original_adj
        learned = norm_laplacian_dense(learned, "sym")
        return (1.0 - self.lambda_coeff) * learned + self.lambda_coeff * original

    def propagate(self):
        item_adj = self.learned_item_adj()
        h = self.item_id_embedding
        for _ in range(self.n_layers):
            h = item_adj @ h
        if self.cf_model == "mf":
            u, i = self.user_embedding, self.item_id_embedding
        else:  # lightgcn (the ngcf setting falls back to it, as in the JAX package)
            out = layer_mean(self.norm_adj, torch.cat([self.user_embedding, self.item_id_embedding]), self.n_ui_layers)
            u, i = out[: self.n_users], out[self.n_users :]
        return u, i + F.normalize(h, dim=1, eps=1e-12)

    def loss(self, state, batch, generator=None):
        users, pos, neg, w = batch["users"], batch["pos"], batch["neg"], batch["weight"]
        ua, ia = self.propagate()
        u, p_e, n_e = ua[users], ia[pos], ia[neg]
        # over a data axis the learned graph (K3 over every item) is the same
        # on every rank; batch_l2 sums the batch's rows
        mf = bpr_loss((u * p_e).sum(1), (u * n_e).sum(1), w, gamma=0.0, rows=batch.get("rows"))
        total = mf + self.reg_weight * batch_l2(u, p_e, n_e, self.batch_size)
        return total, (total,)

    def full_embeddings(self, state):
        return self.propagate()
