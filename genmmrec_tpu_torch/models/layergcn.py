"""LayerGCN: layer-refined graph convolution (counterpart of
``genmmrec_tpu/models/layergcn.py``): per-epoch edge pruning that alternates
between degree-probability and uniform sampling, propagation in which each
layer's output is re-weighted by its cosine similarity to the ego embedding,
sum-reduced BPR plus L2 regularization; the evaluation uses the unpruned
adjacency. The pruned graph keeps its nnz: pruned edges get the value 0."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from genmmrec_tpu_torch.common.init import xavier_uniform
from genmmrec_tpu_torch.common.losses import l2_loss
from genmmrec_tpu_torch.models.base import RecModel, scalar
from genmmrec_tpu_torch.ops.graph import sorted_graph, spmm, unique_ui_pairs


class LayerGCN(RecModel):
    is_multimodal = False

    def __init__(self, config, data):
        super().__init__(config, data)
        self.latent_dim = scalar(config["embedding_size"], int)
        self.n_layers = scalar(config["n_layers"], int)
        self.reg_weight = scalar(config["reg_weight"])
        self.dropout = scalar(config["dropout"])

        users, items = unique_ui_pairs(data.users.cpu().numpy(), data.items.cpu().numpy())
        dev = self.device
        self.ui_users = torch.as_tensor(users, device=dev)
        self.ui_items = torch.as_tensor(items, device=dev)
        self.n_edges = len(users)
        N = self.n_users + self.n_items
        rows = np.concatenate([users, items + self.n_users])
        cols = np.concatenate([items + self.n_users, users])
        order = np.argsort(rows, kind="stable")
        # position of each sorted edge in [v, v], the values of both directions
        self._perm = torch.as_tensor(order, device=dev)
        # the adjacency's structure, built once; each use replaces its values.
        # Symmetric: [v, v] over mirrored edges
        self._adj = sorted_graph(
            torch.as_tensor(rows[order], device=dev), torch.as_tensor(cols[order], device=dev),
            torch.zeros(2 * self.n_edges, device=dev), N, N, symmetric=True,
        )
        du = np.bincount(users, minlength=self.n_users) + 1e-7
        di = np.bincount(items, minlength=self.n_items) + 1e-7
        self.edge_values = torch.as_tensor(
            (np.power(du, -0.5)[users] * np.power(di, -0.5)[items]).astype(np.float32), device=dev
        )
        self.user_embeddings = nn.Parameter(torch.empty(self.n_users, self.latent_dim, device=dev))
        self.item_embeddings = nn.Parameter(torch.empty(self.n_items, self.latent_dim, device=dev))

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        self.user_embeddings.copy_(xavier_uniform(self.user_embeddings.shape, generator))
        self.item_embeddings.copy_(xavier_uniform(self.item_embeddings.shape, generator))

    def _norm_vals(self, keep: torch.Tensor) -> torch.Tensor:
        """Symmetric-normalized values of the kept edges ((n_edges,) 0/1
        float32), in the sorted adjacency's edge order."""
        du = torch.zeros(self.n_users, device=keep.device).index_add_(0, self.ui_users, keep) + 1e-7
        di = torch.zeros(self.n_items, device=keep.device).index_add_(0, self.ui_items, keep) + 1e-7
        v = keep * du[self.ui_users] ** -0.5 * di[self.ui_items] ** -0.5
        return torch.cat([v, v])[self._perm]

    def _full_vals(self) -> torch.Tensor:
        return self._norm_vals(torch.ones(self.n_edges, device=self.device))

    def init_state(self, generator=None) -> dict:
        return {"masked_vals": self._full_vals()}

    @torch.no_grad()
    def pre_epoch(self, state, generator, epoch: int, uniform=None) -> dict:
        """Prune ``dropout`` of the edges for this epoch: Gumbel top-k over
        the log degree weights on even epochs, over nothing (uniform) on odd
        ones. ``uniform`` gives the (n_edges,) U[0, 1) draw in place of the
        generator's."""
        if self.dropout <= 0.0:
            return {"masked_vals": self._full_vals()}
        n_keep = int(self.n_edges * (1.0 - self.dropout))
        if uniform is None:
            uniform = torch.rand(self.n_edges, generator=generator, device=self.device)
        g = -torch.log(-torch.log(uniform + 1e-20) + 1e-20)
        scores = torch.log(self.edge_values) + g if epoch % 2 == 0 else g
        thresh = torch.sort(scores).values[self.n_edges - n_keep]
        return {"masked_vals": self._norm_vals((scores >= thresh).to(torch.float32))}

    def propagate(self, vals: torch.Tensor):
        ego = torch.cat([self.user_embeddings, self.item_embeddings])
        adj = dataclasses.replace(self._adj, vals=vals)
        # safe norm: sqrt(max(Σx², ε)). A plain norm has a NaN gradient at
        # x = 0, and pruning can zero a low-degree node's whole row
        safe_n = lambda v: v / torch.sqrt((v * v).sum(-1, keepdim=True).clamp(min=1e-24))
        ego_n = safe_n(ego)
        x, acc = ego, torch.zeros_like(ego)
        for _ in range(self.n_layers):
            x = spmm(adj, x)
            weights = (safe_n(x) * ego_n).sum(-1)
            x = weights[:, None] * x
            acc = acc + x
        return acc[: self.n_users], acc[self.n_users :]

    def loss(self, state, batch, generator=None):
        users, pos, neg, w = batch["users"], batch["pos"], batch["neg"], batch["weight"]
        ua, ia = self.propagate(state["masked_vals"])
        u = ua[users]
        diff = (u * ia[pos]).sum(dim=1) - (u * ia[neg]).sum(dim=1)
        # the BPR term is summed, not averaged
        mf = -(torch.nn.functional.logsigmoid(diff) * w).sum()
        reg = l2_loss(self.user_embeddings[users], self.item_embeddings[pos], self.item_embeddings[neg])
        total = mf + self.reg_weight * reg
        return total, (total,)

    def full_embeddings(self, state):
        return self.propagate(self._full_vals())
