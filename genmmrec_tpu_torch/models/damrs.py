"""DAMRS: denoising alignment with session graphs (counterpart of
``genmmrec_tpu/models/damrs.py``).

- Mutually masked modal KNN item graphs (``masked_knn_graphs``, on the
  device): each modality's cosine similarity (a float32 product), every
  entry below either modality's mean zeroed in both, then K3's top-k of
  each row; unit values over the out-degrees (``binary_row``).
- A session item graph (``session_graph``): each item's self loop plus its
  neighbours from ``item_graph_dict_file`` (read with numpy, as the JAX
  package reads it) or, without the file, its ``knn_k`` items of most
  shared users (``cooccurrence_neighbours``: the within-user co-occurrence
  ``RᵀR`` of the interaction counts, a float32 product in blocks on the
  device, the diagonal zeroed, K3's top-k, a zero count dropped); the
  edges over their rows' counts, D^-½ A D^-½.
- LightGCN over ``bipartite_norm_adj``; the item-id table through each of
  the three item graphs.
- Loss: modality-weighted BPR (weights from the modal scores, without
  gradient), the pseudo-label neighbour discrimination across the three
  item views (K3's top-10 of the label planes) and the symmetric KL
  between the behavioural and modal user-item probabilities. The loss
  draws nothing.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from genmmrec_tpu_torch.common.init import xavier_uniform
from genmmrec_tpu_torch.common.losses import batch_rows, global_mean, row_mean, weighted_mean
from genmmrec_tpu_torch.common.norm import l2n
from genmmrec_tpu_torch.models.base import RecModel, scalar
from genmmrec_tpu_torch.ops.graph import SparseGraph, bipartite_norm_adj, layer_mean, sorted_graph, spmm
from genmmrec_tpu_torch.ops.precision import full_precision_matmuls
from genmmrec_tpu_torch.ops.topk import grouped_topk

# the item rows of one co-occurrence block
COOCCURRENCE_BLOCK = 2048
# the pseudo-labels of each view
LABEL_K = 10


def binary_row_graph(cols: torch.Tensor, n: int) -> SparseGraph:
    """(n, k) neighbour ids as a row-sorted graph of unit values over the
    out-degrees, (k + 1e-7)^-½ · (k + 1e-7)^-½."""
    k = cols.shape[1]
    rows = torch.arange(n, device=cols.device).repeat_interleave(k)
    val = (k + 1e-7) ** -0.5
    return sorted_graph(rows, cols.reshape(-1), torch.full((n * k,), val * val, device=cols.device), n, n)


def masked_knn_graphs(v_feat: torch.Tensor, t_feat: torch.Tensor, k: int):
    """The image and text graphs: both modalities' cosine similarity, an
    entry below either plane's mean (taken in float64) zeroed in both,
    each row's ``k`` largest by K3."""
    full_precision_matmuls()
    vn = torch.nn.functional.normalize(v_feat.to(torch.float32), dim=1, eps=1e-12)
    tn = torch.nn.functional.normalize(t_feat.to(torch.float32), dim=1, eps=1e-12)
    v_sim, t_sim = vn @ vn.T, tn @ tn.T
    mask = (v_sim < v_sim.mean(dtype=torch.float64)) | (t_sim < t_sim.mean(dtype=torch.float64))
    n = v_sim.shape[0]
    k = min(k, n)
    graphs = []
    for sim in (v_sim, t_sim):
        _, idx = grouped_topk(sim.masked_fill_(mask, 0.0), k)
        graphs.append(binary_row_graph(idx, n))
    return tuple(graphs)


def cooccurrence_neighbours(users, items, n_users: int, n_items: int, k: int, device):
    """Each item's ``k`` items of most shared users (``RᵀR`` of the
    interaction counts, a repeated pair counted twice; the diagonal
    zeroed), on ``device``: (neighbours (n_items, k) int64, counts
    (n_items, k) float32, 0 where an item has fewer), counts descending,
    ties to the lower item id (K3's order)."""
    full_precision_matmuls()
    r = torch.zeros(n_users, n_items, device=device)
    r.index_put_((torch.as_tensor(users, device=device).long(), torch.as_tensor(items, device=device).long()),
                 torch.ones(len(users), device=device), accumulate=True)
    nbrs, counts = [], []
    for lo in range(0, n_items, COOCCURRENCE_BLOCK):
        # integer counts far below 2^24: exact in float32
        co = r[:, lo : lo + COOCCURRENCE_BLOCK].T @ r
        rows = torch.arange(co.shape[0], device=device)
        co[rows, rows + lo] = 0.0
        v, i = grouped_topk(co, k)
        nbrs.append(i)
        counts.append(v)
    return torch.cat(nbrs), torch.cat(counts)


def session_graph(config, users, items, n_items: int, n_users: int, k: int, device):
    """The session item graph: self loops plus the file's neighbours or the
    co-occurrence neighbours of positive count, each edge
    (deg[r] + 1e-7)^-½ (deg[c] + 1e-7)^-½ with deg the row's edge count;
    stably row-sorted, self loop first."""
    path = os.path.join(
        os.path.abspath(os.path.join(config["data_path"] or "./data/", config["dataset"] or "")),
        str(config["item_graph_dict_file"] or "item_graph_dict.npy"),
    )
    loops = torch.arange(n_items, device=device)
    if os.path.isfile(path):
        d = np.load(path, allow_pickle=True).item()
        rr, cc = [], []
        for i in range(n_items):
            if i in d:
                ns = list(d[i][0])
                rr.append(np.full(len(ns), i, np.int64))
                cc.append(np.asarray(ns, np.int64))
        rr = torch.as_tensor(np.concatenate(rr) if rr else np.zeros(0, np.int64), device=device)
        cc = torch.as_tensor(np.concatenate(cc) if cc else np.zeros(0, np.int64), device=device)
    else:
        nbrs, counts = cooccurrence_neighbours(users, items, n_users, n_items, min(k, n_items - 1), device)
        keep = (counts > 0).reshape(-1)
        rr = loops.repeat_interleave(nbrs.shape[1])[keep]
        cc = nbrs.reshape(-1)[keep]
    rows, cols = torch.cat([loops, rr]), torch.cat([loops, cc])
    dis = (torch.bincount(rows, minlength=n_items).to(torch.float64) + 1e-7).pow(-0.5)
    vals = (dis[rows] * dis[cols]).to(torch.float32)
    rows, order = torch.sort(rows, stable=True)
    return sorted_graph(rows, cols[order], vals[order], n_items, n_items)


class DAMRS(RecModel):
    def __init__(self, config, data):
        super().__init__(config, data)
        d = self.embedding_dim = scalar(config["embedding_size"], int)
        self.knn_k = scalar(config["knn_k"], int)
        self.n_layers = scalar(config["n_mm_layers"], int)
        self.n_ui_layers = scalar(config["n_ui_layers"], int)
        self.reg_weight = scalar(config["reg_weight"], default=1e-4)
        self.kl_weight = scalar(config["kl_weight"])
        self.neighbor_weight = scalar(config["neighbor_weight"])
        dev = self.device
        users, items = data.users.cpu().numpy(), data.items.cpu().numpy()
        self.norm_adj = bipartite_norm_adj(users, items, self.n_users, self.n_items, dev)
        self.image_adj, self.text_adj = masked_knn_graphs(self.v_feat, self.t_feat, self.knn_k)
        self.session_adj = session_graph(config, users, items, self.n_items, self.n_users, self.knn_k, dev)
        self.user_embedding = nn.Parameter(torch.empty(self.n_users, d, device=dev))
        self.item_id_embedding = nn.Parameter(torch.empty(self.n_items, d, device=dev))

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        for p in (self.user_embedding, self.item_id_embedding):
            p.copy_(xavier_uniform(p.shape, generator))

    def forward(self):
        out = layer_mean(self.norm_adj, torch.cat([self.user_embedding, self.item_id_embedding]), self.n_ui_layers)
        h = self.item_id_embedding
        views = []
        for adj in (self.text_adj, self.image_adj, self.session_adj):
            v = h
            for _ in range(self.n_layers):
                v = spmm(adj, v)
            views.append(v)
        return (out[: self.n_users], out[self.n_users :], *views)

    @staticmethod
    def _label_pred(emb, aug):
        return torch.softmax(l2n(emb) @ l2n(aug).T, dim=1)

    @staticmethod
    def _pseudo_labels(p1, p2, p3):
        """Top-10 of p1 + p2 + 2·p3, then the top-10 of p3 without them (K3)."""
        _, mm_pos = grouped_topk((p1 + p2 + p3 + p3).detach(), LABEL_K)
        prob = p3.detach().scatter(1, mm_pos, 0.0)
        _, s_pos = grouped_topk(prob, LABEL_K)
        return mm_pos, s_pos

    @staticmethod
    def _neighbor_disc(mm_pos, s_pos, emb, aug, weights, temperature=0.2, rows=None):
        n_aug, n_emb = l2n(aug), l2n(emb)
        score = lambda idx: torch.exp(torch.einsum("bd,bkd->bk", n_emb, n_aug[idx]) / temperature).sum(1)
        mm_score, s_score = score(mm_pos), score(s_pos)
        ttl = torch.exp(n_emb @ n_aug.T / temperature).sum(1)
        per = -torch.log(mm_score / ttl + 1e-9) - torch.log(s_score / (ttl - mm_score).clamp(min=1e-9) + 1e-9)
        return weighted_mean(per, weights, rows)

    @staticmethod
    def _kl(p1, p2, eps=1e-8):
        p1, p2 = p1.clamp(eps, 1 - eps), p2.clamp(eps, 1 - eps)
        return p1 * (torch.log(p1) - torch.log(p2)) + (1 - p1) * (torch.log(1 - p1) - torch.log(1 - p2))

    def loss(self, state, batch, generator=None):
        """Over a data axis (``batch["rows"]``): the label planes, their K3
        top-k and the BPR weights are per row, on this rank's rows; the
        user-item probability planes take every rank's items as columns; the
        negatives' mean score is the global batch's."""
        users, pos, neg, w = batch["users"], batch["pos"], batch["neg"], batch["weight"]
        rows = batch.get("rows")
        u_emb, i_emb, h_t, h_v, h_s = self.forward()
        w2 = torch.cat([w, w])
        i_id = torch.cat([pos, neg])
        p_t, p_v, p_s = (self._label_pred(h[i_id], h) for h in (h_t, h_v, h_s))
        nd = 0.0
        for (a, b, c), h in (((p_t, p_v, p_s), h_s), ((p_t, p_s, p_v), h_v), ((p_v, p_s, p_t), h_t)):
            mm, s = self._pseudo_labels(a, b, c)
            nd = nd + self._neighbor_disc(mm, s, h[i_id], h, w2, rows=rows)
        nd_loss = nd / 3.0

        it = (h_t + h_s + h_v) / 3.0
        ue = u_emb[users]
        # every rank's items are the planes' columns (in another order, which
        # the mean does not see)
        p_g = torch.sigmoid(ue @ batch_rows(l2n(i_emb[i_id]), rows).T)
        p_m = torch.sigmoid(ue @ batch_rows(l2n(it[i_id]), rows).T)
        kl_loss = row_mean(self._kl(p_g, p_m) + self._kl(p_m, p_g), rows)

        # modality-weighted BPR: the weights carry no gradient
        modal = lambda idx: torch.sigmoid(torch.stack([(ue * l2n(h[idx])).sum(1) for h in (h_t, h_s, h_v)]))
        p_scores, n_scores = modal(pos), modal(neg)
        p_mean = p_scores.mean(0).detach()
        p_var = p_scores.var(0, correction=0).detach()
        n_mean = global_mean(n_scores.detach(), rows)
        pos_weight = (p_mean * torch.exp(-p_var) ** 2.0).clamp(0.0, 1.0).detach()
        mask = (p_mean < n_mean).to(torch.float32)
        neg_weight = ((p_scores.amax(0) - n_mean) * mask).clamp(0.0, 1.0).detach()

        ia = i_emb + it
        pos_s, neg_s = (ue * ia[pos]).sum(1), (ue * ia[neg]).sum(1)
        per = -(torch.log(torch.sigmoid(pos_s - neg_s) + 1e-12) * pos_weight
                + torch.log(torch.sigmoid(neg_s - pos_s) + 1e-12) * neg_weight)
        mf = weighted_mean(per, w, rows)
        total = mf + self.neighbor_weight * nd_loss + self.kl_weight * kl_loss
        return total, (total,)

    def full_embeddings(self, state):
        u_emb, i_emb, h_t, h_v, h_s = self.forward()
        return u_emb, i_emb + (h_v + h_t + h_s) / 3.0
