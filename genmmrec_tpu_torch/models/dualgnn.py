"""DualGNN: a user co-occurrence graph beside the modality towers
(counterpart of ``genmmrec_tpu/models/dualgnn.py``).

- A GCN tower per modality: the user preference matrix and the
  MLP-projected features, two ``add`` hops (K1) over the symmetric
  user-item edges with the degree norm ``deg(src)^-½ · deg(dst)^-½``
  (mirrored, so the backward runs on the same edges), ``x + h + h1``. The
  reference builds modality-dropped edge lists but its forward never reads
  them, so every tower propagates over the full edges.
- The fused user representation mixes ``v_rep + t_rep`` with ``t_rep`` by
  ``weight_u`` (the reference aliases ``representation = v_rep`` and adds
  ``t_rep`` in place), then adds the weighted sum over the user's top-40
  co-occurring users (``user_graph``), a K1 product over a graph of 40
  edges a user.
- Loss: -mean(log₂ σ(pos − neg)) plus the preference and weight
  regularizer.

The user graph (``build_user_graph``) is read from
``user_graph_dict.npy`` when the file exists, as the JAX package reads it,
and otherwise built on the device from the train co-occurrence counts:
blocks of ``R[b] @ Rᵀ`` over the 0/1 matrix of unique pairs, the diagonal
zeroed, K3's top-40 of each row, a zero count at -inf, the softmax with
empty rows at zero. The JAX package builds the same counts on the host.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from genmmrec_tpu_torch.common.init import init_linear, kaiming_uniform_default, xavier_normal
from genmmrec_tpu_torch.common.losses import bpr_loss, row_mean, table_share
from genmmrec_tpu_torch.common.norm import l2n
from genmmrec_tpu_torch.models.base import RecModel, scalar
from genmmrec_tpu_torch.ops.graph import SparseGraph, cooccurrence_topk, sorted_graph, spmm, unique_ui_pairs
from genmmrec_tpu_torch.ops.mp import degree, message_graph, propagate, sort_edges_by_dst

def _neighbours_from_file(path: str, n_users: int, k: int):
    """The file's (nbrs, counts) of each user, cut or cycled to k; -inf
    where a user has none (the JAX package's loop)."""
    nbrs = np.zeros((n_users, k), np.int64)
    wts = np.full((n_users, k), -np.inf, np.float64)
    d = np.load(path, allow_pickle=True).item()
    for u in range(n_users):
        ns, ws = d.get(u, ([], []))
        ns, ws = list(ns)[:k], list(ws)[:k]
        if not ns:
            continue
        while len(ns) < k:
            ns.append(ns[len(ns) % max(1, len(ns)) - 1])
            ws.append(ws[len(ws) % max(1, len(ws)) - 1])
        nbrs[u] = ns
        wts[u] = ws
    return nbrs, wts


def build_user_graph(config, users, items, n_users: int, n_items: int, k: int, device) -> SparseGraph:
    """The user-user graph: each user's k neighbours (``user_graph_dict.npy``
    or ``cooccurrence_topk``) with the softmax of their counts as values,
    zero for a user with none; a row-sorted (U, U) graph of k edges a user."""
    path = os.path.join(
        os.path.abspath(os.path.join(config["data_path"] or "./data/", config["dataset"] or "")),
        config["user_graph_dict_file"] or "user_graph_dict.npy",
    )
    if os.path.isfile(path):
        nbrs, wts = (torch.as_tensor(a, device=device) for a in _neighbours_from_file(path, n_users, k))
    else:
        nbrs, wts = cooccurrence_topk(users, items, n_users, n_items, k, device)
    m = wts.max(dim=1, keepdim=True).values
    finite = torch.isfinite(m)
    e = torch.where(torch.isfinite(wts), torch.exp(wts - torch.where(finite, m, 0.0)), 0.0)
    s = e.sum(dim=1, keepdim=True)
    w = torch.where(finite & (s > 0), e / s.clamp(min=1e-12), 0.0)
    rows = torch.arange(n_users, device=device).repeat_interleave(k)
    return sorted_graph(rows, nbrs.reshape(-1), w.reshape(-1).to(torch.float32), n_users, n_users)


class DualGNN(RecModel):
    def __init__(self, config, data):
        super().__init__(config, data)
        self.dim_latent = 64
        self.reg_weight = scalar(config["reg_weight"])
        self.k = 40
        self.N = self.n_users + self.n_items
        dev = self.device
        users, items = unique_ui_pairs(data.users.cpu().numpy(), data.items.cpu().numpy())
        src, dst = sort_edges_by_dst(
            np.concatenate([users, items + self.n_users]), np.concatenate([items + self.n_users, users])
        )
        src_t, dst_t = torch.as_tensor(src, device=dev), torch.as_tensor(dst, device=dev)
        norm = (degree(src_t, self.N)[src_t] + 1e-12) ** -0.5 * (degree(dst_t, self.N)[dst_t] + 1e-12) ** -0.5
        self.graph = message_graph(src, dst, self.N, dev, vals=norm, symmetric=True)
        self.user_graph = build_user_graph(config, users, items, self.n_users, self.n_items, self.k, dev)
        d = self.dim_latent
        for m, feats in (("v", self.v_feat), ("t", self.t_feat)):
            setattr(self, f"{m}_preference", nn.Parameter(torch.empty(self.n_users, d, device=dev)))
            setattr(self, f"{m}_mlp", nn.Linear(feats.shape[1], 4 * d, device=dev))
            setattr(self, f"{m}_mlp1", nn.Linear(4 * d, d, device=dev))
        self.weight_u = nn.Parameter(torch.empty(self.n_users, 2, 1, device=dev))
        self.weight_i = nn.Parameter(torch.empty(self.n_items, 2, 1, device=dev))

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        # the reference xavier-inits only the preferences and weight_u/i;
        # its MLPs keep nn.Linear's defaults
        for m in ("v", "t"):
            getattr(self, f"{m}_preference").copy_(xavier_normal(getattr(self, f"{m}_preference").shape, generator))
            init_linear(getattr(self, f"{m}_mlp"), generator, init=kaiming_uniform_default)
            init_linear(getattr(self, f"{m}_mlp1"), generator, init=kaiming_uniform_default)
        for p in (self.weight_u, self.weight_i):
            p.copy_(torch.softmax(xavier_normal(p.shape, generator), dim=1))

    def _tower(self, m: str, feats):
        tf = getattr(self, f"{m}_mlp1")(F.leaky_relu(getattr(self, f"{m}_mlp")(feats), 0.01))
        x = l2n(torch.cat([getattr(self, f"{m}_preference"), tf]))
        h = propagate(x, self.graph, "add")
        return x + h + propagate(h, self.graph, "add")

    def forward(self):
        v_rep, t_rep = self._tower("v", self.v_feat), self._tower("t", self.t_feat)
        representation = v_rep + t_rep
        U = self.n_users
        user_rep = (torch.stack([representation[:U], t_rep[:U]], dim=2) @ self.weight_u)[:, :, 0]
        user_rep = user_rep + spmm(self.user_graph, user_rep)
        return torch.cat([user_rep, representation[U:]])

    def _bpr_log2(self, u, p_e, n_e, w, rows=None):
        """-mean(log₂ σ(pos − neg)) over the weighted rows."""
        return bpr_loss((u * p_e).sum(1), (u * n_e).sum(1), w, gamma=1e-12, rows=rows) / math.log(2.0)

    def loss(self, state, batch, generator=None):
        users, pos, neg, w = batch["users"], batch["pos"], batch["neg"], batch["weight"]
        rows = batch.get("rows")
        out = self.forward()
        bpr = self._bpr_log2(out[users], out[pos + self.n_users], out[neg + self.n_users], w, rows)
        reg = (
            row_mean(self.v_preference[users] ** 2, rows) + row_mean(self.t_preference[users] ** 2, rows)
            + table_share((self.weight_u**2).mean(), rows) + table_share((self.weight_i**2).mean(), rows)
        )
        total = bpr + self.reg_weight * reg
        return total, (total,)

    def full_embeddings(self, state):
        out = self.forward()
        return out[: self.n_users], out[self.n_users :]
