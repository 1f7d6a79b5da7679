"""LayerGCN: layer-refined graph convolution (counterpart of
``genmmrec_tpu/models/layergcn.py``): per-epoch edge pruning that alternates
between degree-probability and uniform sampling, propagation in which each
layer's output is re-weighted by its cosine similarity to the ego embedding,
sum-reduced BPR plus L2 regularization; the evaluation uses the unpruned
adjacency. The pruned graph keeps its nnz: pruned edges get the value 0."""

from __future__ import annotations

import torch
from torch import nn

from genmmrec_tpu_torch.common.init import xavier_uniform
from genmmrec_tpu_torch.common.losses import l2_loss
from genmmrec_tpu_torch.models.base import RecModel, scalar
from genmmrec_tpu_torch.ops.graph import SampledUIGraph, spmm


class LayerGCN(RecModel):
    is_multimodal = False

    def __init__(self, config, data):
        super().__init__(config, data)
        self.latent_dim = scalar(config["embedding_size"], int)
        self.n_layers = scalar(config["n_layers"], int)
        self.reg_weight = scalar(config["reg_weight"])
        self.dropout = scalar(config["dropout"])

        self.ui = SampledUIGraph(
            data.users.cpu().numpy(), data.items.cpu().numpy(), self.n_users, self.n_items, self.device
        )
        self.n_edges = self.ui.n_edges
        self.user_embeddings = nn.Parameter(torch.empty(self.n_users, self.latent_dim, device=self.device))
        self.item_embeddings = nn.Parameter(torch.empty(self.n_items, self.latent_dim, device=self.device))

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        self.user_embeddings.copy_(xavier_uniform(self.user_embeddings.shape, generator))
        self.item_embeddings.copy_(xavier_uniform(self.item_embeddings.shape, generator))

    def _full_vals(self) -> torch.Tensor:
        return self.ui.values()

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
        keep = self.ui.sample_keep(n_keep, uniform, weighted=epoch % 2 == 0)
        return {"masked_vals": self.ui.values(keep)}

    def propagate(self, vals: torch.Tensor):
        ego = torch.cat([self.user_embeddings, self.item_embeddings])
        adj = self.ui.graph(vals)
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
        """Every term is a sum over the batch's rows: over a data axis
        (``batch["rows"]``) this rank's rows give its share as they are."""
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
