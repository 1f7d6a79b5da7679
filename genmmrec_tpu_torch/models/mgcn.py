"""MGCN: modality-purified graph convolution (counterpart of
``genmmrec_tpu/models/mgcn.py``).

- Purifier: the item-id embedding gated by each modality's projected
  features (``sigmoid(gate(trs(feat)))``).
- A user-item LightGCN view over the jointly rowsum^-½-normalized
  adjacency (``sym_ui_adj``, value-symmetric: K1 forward and backward on
  the same edges), ``n_ui_layers`` layers averaged.
- Each modality's items through ``n_layers`` hops of its KNN item graph
  (K3's top-k at set-up, "sym" values), lifted to the users by one
  column-batched product over the normalized R block (``spmm_multi``).
- Fuser: an attention over the two modal views gives the common part;
  preference gates of the content view scale what is left of each.
- Loss: BPR plus batch-scaled L2 plus ``cl_loss`` times the InfoNCE
  (temperature 0.2) of the side against the content view, items and users.
  The forward draws nothing.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from genmmrec_tpu_torch.common.init import init_linear, xavier_uniform
from genmmrec_tpu_torch.common.losses import batch_rows, bpr_loss, weighted_mean
from genmmrec_tpu_torch.models.base import RecModel, scalar
from genmmrec_tpu_torch.ops.graph import _from_host, knn_graph_sparse, layer_mean, spmm, spmm_multi


def l2n_max(x: torch.Tensor) -> torch.Tensor:
    """Each row over max(its L2 norm, 1e-12) (the JAX MGCN's ``_l2n``)."""
    return F.normalize(x, dim=1, eps=1e-12)


def sym_ui_adj(users: np.ndarray, items: np.ndarray, n_users: int, n_items: int, device):
    """The user-item adjacency of every train interaction (a repeated pair
    stays two edges), both directions, D^-½ A D^-½ with D the edge counts
    (a node of none at 0), value-symmetric; and its user-to-item block as
    the n_users × n_items R with the same values. Built on the host with the
    JAX package's numpy code."""
    users, items = users.astype(np.int64), items.astype(np.int64)
    N = n_users + n_items
    rows = np.concatenate([users, items + n_users])
    cols = np.concatenate([items + n_users, users])
    deg = np.bincount(rows, minlength=N).astype(np.float64)
    with np.errstate(divide="ignore"):
        dis = np.where(deg > 0, np.power(deg, -0.5), 0.0)
    nvals = (dis[rows] * dis[cols]).astype(np.float32)
    adj = _from_host(rows, cols, nvals, N, N, device, symmetric=True)
    R = _from_host(users, items, nvals[: len(users)], n_users, n_items, device, symmetric=False)
    return adj, R


def infonce(v1, v2, temp: float, weights, eps: float = 0.0, rows=None) -> torch.Tensor:
    """Weighted mean of -log(exp(n1·n2/T) / Σ_j exp(n1·n2_j/T) + eps) over
    the rows, with ``l2n_max`` views (MGCN's, SMORE's and GUME's form). Over
    ``rows`` the j run over every rank's rows."""
    n1, n2 = l2n_max(v1), l2n_max(v2)
    pos = torch.exp((n1 * n2).sum(-1) / temp)
    ttl = torch.exp(n1 @ batch_rows(n2, rows).T / temp).sum(1)
    per = -torch.log(pos / ttl + eps)
    return weighted_mean(per, weights, rows)


def batch_l2(u, p_e, n_e, batch_size: int) -> torch.Tensor:
    """½(‖u‖² + ‖p‖² + ‖n‖²) over the configured batch size."""
    return 0.5 * ((u**2).sum() + (p_e**2).sum() + (n_e**2).sum()) / batch_size


class MGCN(RecModel):
    def __init__(self, config, data):
        super().__init__(config, data)
        self.cl_loss = scalar(config["cl_loss"])
        self.n_ui_layers = scalar(config["n_ui_layers"], int)
        d = self.embedding_dim = scalar(config["embedding_size"], int)
        self.knn_k = scalar(config["knn_k"], int)
        self.n_layers = scalar(config["n_layers"], int)
        self.reg_weight = scalar(config["reg_weight"])
        self.batch_size = int(config["train_batch_size"])
        dev = self.device
        users, items = data.users.cpu().numpy(), data.items.cpu().numpy()
        self.norm_adj, self.R = sym_ui_adj(users, items, self.n_users, self.n_items, dev)
        self.image_original_adj = knn_graph_sparse(self.v_feat, self.knn_k, "sym")
        self.text_original_adj = knn_graph_sparse(self.t_feat, self.knn_k, "sym")
        self.user_embedding = nn.Parameter(torch.empty(self.n_users, d, device=dev))
        self.item_id_embedding = nn.Parameter(torch.empty(self.n_items, d, device=dev))
        self.image_trs = nn.Linear(self.v_feat.shape[1], d, device=dev)
        self.text_trs = nn.Linear(self.t_feat.shape[1], d, device=dev)
        self.query1 = nn.Linear(d, d, device=dev)
        self.query2 = nn.Linear(d, 1, bias=False, device=dev)
        for name in ("gate_v", "gate_t", "gate_image_prefer", "gate_text_prefer"):
            setattr(self, name, nn.Linear(d, d, device=dev))

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        self.user_embedding.copy_(xavier_uniform(self.user_embedding.shape, generator))
        self.item_id_embedding.copy_(xavier_uniform(self.item_id_embedding.shape, generator))
        for name in ("image_trs", "text_trs", "query1", "query2", "gate_v", "gate_t", "gate_image_prefer",
                     "gate_text_prefer"):
            init_linear(getattr(self, name), generator, init=xavier_uniform, zero_bias=True)

    def forward(self, train: bool = False):
        image_item = self.item_id_embedding * torch.sigmoid(self.gate_v(self.image_trs(self.v_feat)))
        text_item = self.item_id_embedding * torch.sigmoid(self.gate_t(self.text_trs(self.t_feat)))
        content = layer_mean(self.norm_adj, torch.cat([self.user_embedding, self.item_id_embedding]),
                             self.n_ui_layers)
        for _ in range(self.n_layers):
            image_item = spmm(self.image_original_adj, image_item)
        for _ in range(self.n_layers):
            text_item = spmm(self.text_original_adj, text_item)
        img_u, txt_u = spmm_multi(self.R, [image_item, text_item])
        image_embeds = torch.cat([img_u, image_item])
        text_embeds = torch.cat([txt_u, text_item])
        query = lambda x: self.query2(torch.tanh(self.query1(x)))
        wgt = torch.softmax(torch.cat([query(image_embeds), query(text_embeds)], dim=-1), dim=-1)
        common = wgt[:, 0:1] * image_embeds + wgt[:, 1:2] * text_embeds
        sep_img = torch.sigmoid(self.gate_image_prefer(content)) * (image_embeds - common)
        sep_txt = torch.sigmoid(self.gate_text_prefer(content)) * (text_embeds - common)
        side = (sep_img + sep_txt + common) / 3.0
        all_e = content + side
        u, i = all_e[: self.n_users], all_e[self.n_users :]
        return (u, i, side, content) if train else (u, i)

    def loss(self, state, batch, generator=None):
        users, pos, neg, w = batch["users"], batch["pos"], batch["neg"], batch["weight"]
        rows = batch.get("rows")
        ua, ia, side, content = self.forward(train=True)
        u, p_e, n_e = ua[users], ia[pos], ia[neg]
        mf = bpr_loss((u * p_e).sum(1), (u * n_e).sum(1), w, gamma=0.0, rows=rows)
        # a sum over the batch's rows over the configured batch size
        reg = self.reg_weight * batch_l2(u, p_e, n_e, self.batch_size)
        nu = self.n_users
        nce = lambda a, b: infonce(a, b, 0.2, w, rows=rows)
        cl = nce(side[nu:][pos], content[nu:][pos]) + nce(side[:nu][users], content[:nu][users])
        total = mf + reg + self.cl_loss * cl
        return total, (total,)

    def full_embeddings(self, state):
        return self.forward()
