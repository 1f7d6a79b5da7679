"""PGL: a perturbed graph learning variant (counterpart of
``genmmrec_tpu/models/pgl.py``).

- Items: the two modal projections, each row-normalized, side by side
  (2·``feat_embed_dim``); users: two tables side by side.
- The frozen mixed modal item graph (``mixed_knn_graph``, FREEDOM's:
  ``binary_row`` KNN graphs on K3, image edges weighted
  ``mm_image_weight``).
- The training graph: in the published ``local`` mode a per-epoch sample
  of 30% of the unique user-item pairs, by Gumbel top-k in proportion to
  their degree weights (``pre_epoch``; its uniforms can be passed), the
  kept pairs re-normalized, both directions (value-symmetric); in
  ``global`` mode a subgraph built once from a truncated SVD of the
  normalized adjacency (``global_subgraph``: scipy's ``svds`` on the host,
  as in the JAX package; ``u·diag·vᵀ`` has no sign ambiguity), entries
  below 1e-3 in magnitude dropped. The evaluation takes the full graph.
- Loss: BPR plus ``reg_weight`` times the mean of two self-InfoNCE terms
  (temperature 0.2) between dropout-perturbed copies of the batch's users
  and positive items. The four dropout masks can be passed to ``loss``
  (``keep``: bool planes, users twice then items twice).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from genmmrec_tpu_torch.common.init import init_linear, xavier_normal, xavier_uniform
from genmmrec_tpu_torch.common.losses import batch_rows, bpr_loss, weighted_mean
from genmmrec_tpu_torch.common.norm import l2n
from genmmrec_tpu_torch.models.base import RecModel, scalar
from genmmrec_tpu_torch.ops.graph import SampledUIGraph, _from_host, layer_mean, mixed_knn_graph, spmm

# the share of the unique pairs the local mode keeps each epoch
LOCAL_KEEP = 0.3
# the global subgraph drops entries of smaller magnitude
GLOBAL_THRESHOLD = 1e-3


def global_subgraph(users: np.ndarray, items: np.ndarray, n_users: int, n_items: int, dim: int, device):
    """The thresholded SVD product subgraph: of the D^-½ A D^-½ adjacency
    of the unique pairs (degrees + 1e-7), the ``min(dim, N - 2)`` largest
    singular triplets by ``svds``; with ``nb = dim // 4``,
    ``M = U[:, :nb] diag(s[:nb]·s[-nb:]) Vᵀ[:nb]``, entries below
    ``GLOBAL_THRESHOLD`` in magnitude dropped. Dense (N, N) on the host, as
    in the JAX package."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.linalg import svds

    N = n_users + n_items
    r = np.concatenate([users, items + n_users])
    c = np.concatenate([items + n_users, users])
    dis = np.power(np.bincount(r, minlength=N).astype(np.float64) + 1e-7, -0.5)
    L = coo_matrix((dis[r] * dis[c], (r, c)), shape=(N, N)).tocsc()
    u, s, vt = svds(L, k=min(dim, N - 2))
    nb = int(0.25 * dim)
    M = u[:, :nb] @ np.diag(s[:nb] * s[-nb:]) @ vt[:nb, :]
    M = M * (np.abs(M) >= GLOBAL_THRESHOLD)
    rr, cc = np.nonzero(M)
    return _from_host(rr, cc, M[rr, cc].astype(np.float32), N, N, device, symmetric=False)


class PGL(RecModel):
    def __init__(self, config, data):
        super().__init__(config, data)
        self.mode = str(scalar(config["mode"], str) if config["mode"] else "local")
        d = self.embedding_dim = scalar(config["embedding_size"], int)
        self.feat_embed_dim = scalar(config["feat_embed_dim"], int)
        self.knn_k = scalar(config["knn_k"], int)
        self.n_layers = scalar(config["n_mm_layers"], int)
        self.n_ui_layers = scalar(config["n_ui_layers"], int)
        self.reg_weight = scalar(config["reg_weight"])
        self.mm_image_weight = scalar(config["mm_image_weight"])
        self.dropout = scalar(config["dropout"])
        dev = self.device
        users, items = data.users.cpu().numpy(), data.items.cpu().numpy()
        self.ui = SampledUIGraph(users, items, self.n_users, self.n_items, dev)
        self.mm_adj = mixed_knn_graph(self.v_feat, self.t_feat, self.knn_k, self.mm_image_weight)
        if self.mode == "global":
            self.sub_graph = global_subgraph(
                self.ui.users.cpu().numpy(), self.ui.items.cpu().numpy(), self.n_users, self.n_items, d, dev
            )
        self.user_image = nn.Parameter(torch.empty(self.n_users, d, device=dev))
        self.user_text = nn.Parameter(torch.empty(self.n_users, d, device=dev))
        self.image_trs = nn.Linear(self.v_feat.shape[1], self.feat_embed_dim, device=dev)
        self.text_trs = nn.Linear(self.t_feat.shape[1], self.feat_embed_dim, device=dev)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        for p in (self.user_image, self.user_text):
            p.copy_(xavier_uniform(p.shape, generator))
        for layer in (self.image_trs, self.text_trs):
            init_linear(layer, generator, init=xavier_normal, zero_bias=True)

    def init_state(self, generator=None) -> dict:
        return {"sub_vals": self.ui.values()}

    @torch.no_grad()
    def pre_epoch(self, state, generator, epoch: int, uniform=None) -> dict:
        """The local mode's graph of this epoch: ``LOCAL_KEEP`` of the pairs
        by Gumbel top-k over ``uniform`` ((n_edges,) U[0, 1), else drawn),
        in proportion to their degree weights."""
        if self.mode != "local":
            return state
        if uniform is None:
            uniform = torch.rand(self.ui.n_edges, generator=generator, device=self.device)
        n_keep = int(self.ui.n_edges * LOCAL_KEEP)
        return {"sub_vals": self.ui.values(self.ui.sample_keep(n_keep, uniform))}

    def _train_graph(self, state):
        return self.sub_graph if self.mode == "global" else self.ui.graph(state["sub_vals"])

    def forward(self, adj):
        item_embeds = torch.cat([l2n(self.image_trs(self.v_feat)), l2n(self.text_trs(self.t_feat))], dim=1)
        h = item_embeds
        for _ in range(self.n_layers):
            h = spmm(self.mm_adj, h)
        out = layer_mean(adj, torch.cat([torch.cat([self.user_image, self.user_text], dim=1), item_embeds]),
                         self.n_ui_layers)
        return out[: self.n_users], out[self.n_users :] + h

    @staticmethod
    def _infonce(v1, v2, temp, weights, rows=None):
        n1, n2 = l2n(v1), l2n(v2)
        pos = torch.exp((n1 * n2).sum(-1) / temp)
        ttl = torch.exp(n1 @ batch_rows(n2, rows).T / temp).sum(1)
        return weighted_mean(-torch.log(pos / ttl), weights, rows)

    def draws(self, generator, batch_size: int):
        """The loss's four dropout masks: two over the batch's users, two
        over its positive items."""
        shapes = [(batch_size, 2 * self.embedding_dim)] * 2 + [(batch_size, 2 * self.feat_embed_dim)] * 2
        return tuple(torch.rand(s, generator=generator, device=self.device) < 1.0 - self.dropout for s in shapes)

    def loss(self, state, batch, generator=None, keep=None):
        """``keep``: the four dropout masks (``draws``) in place of the
        generator's. Over a data axis (``batch["rows"]``) they are the global
        batch's, given or drawn, and this rank takes its rows of them."""
        users, pos, neg, w = batch["users"], batch["pos"], batch["neg"], batch["weight"]
        rows = batch.get("rows")
        ua, ia = self.forward(self._train_graph(state))
        u, p_e, n_e = ua[users], ia[pos], ia[neg]
        mf = bpr_loss((u * p_e).sum(1), (u * n_e).sum(1), w, gamma=0.0, rows=rows)
        if keep is None:
            keep = self.draws(generator, users.shape[0] if rows is None else rows.n)
        if rows is not None:
            keep = rows.local(keep)
        drop = lambda m, x: torch.where(m, x / (1.0 - self.dropout), 0.0)
        cl = (self._infonce(drop(keep[0], u), drop(keep[1], u), 0.2, w, rows)
              + self._infonce(drop(keep[2], p_e), drop(keep[3], p_e), 0.2, w, rows)) / 2.0
        total = mf + self.reg_weight * cl
        return total, (total,)

    def full_embeddings(self, state):
        return self.forward(self.ui.graph(self.ui.values()))
