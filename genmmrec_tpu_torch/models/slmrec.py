"""SLMRec: self-supervised learning for multimedia recommendation
(counterpart of ``genmmrec_tpu/models/slmrec.py``).

- Three LightGCN towers (the item-id table, the projected visual and the
  projected text features), each beside the shared user table, over the
  symmetric D^-½ A D^-½ adjacency of the unique pairs (degrees + 1e-8);
  the three go through K1 as one column-batched product. Their users and
  their items are concatenated (``mm_fusion_mode: concat``, else averaged)
  and projected by ``user_after`` / ``item_after``.
- Main loss: the in-batch cross-entropy of the row-normalized users
  against their positive items (temperature ``temp``).
- SSL task (``ssl_task``), weighted by ``ssl_alpha``:
  - FAC (published): projection heads from the id items to the visual and
    on to the text items, two in-batch cross-entropies;
  - FD: two views, each tower's every layer through dropout;
  - FM: two distinct modalities drawn and zeroed on the item side, one for
    each view, with the reference's crossed accumulation (each view
    collects the other's layers); FD+FM adds FD's dropout.
- Scores: the sigmoid of ``u @ iᵀ``, in float32 whatever ``eval_dtype``
  says, as in the JAX package.

Every draw can be passed to ``loss`` (``draws``, as ``draws()`` makes
them: ``keep``, two views of three towers of ``layer_num`` bool (N, d)
planes, for FD and FD+FM; ``fm_idx``, the two modality indices, for FM and
FD+FM); else they are drawn from the generator.
"""

from __future__ import annotations

import torch
from torch import nn

from genmmrec_tpu_torch.common.init import init_linear, xavier_uniform
from genmmrec_tpu_torch.common.losses import batch_rows, weighted_mean
from genmmrec_tpu_torch.common.norm import l2n
from genmmrec_tpu_torch.models.base import RecModel, scalar
from genmmrec_tpu_torch.ops.graph import bipartite_norm_adj, spmm

TOWERS = 3
# the masking index of each tower (id, visual, text), as in the reference
MASK_ID = (2, 0, 1)
HEADS = (("g_i_iv", 1), ("g_v_iv", 1), ("g_iv_iva", 1), ("g_a_iva", 1), ("g_iva_ivat", 2), ("g_t_ivat", 2))


def in_batch_ce(v1, v2, temp: float, weights, rows=None) -> torch.Tensor:
    """Weighted mean over the rows of the cross-entropy of ``v1 @ v2ᵀ / T``
    with the diagonal as labels. Over ``rows`` the columns are every rank's
    rows of ``v2``, and row i's label is its global row."""
    logp = torch.log_softmax(v1 @ batch_rows(v2, rows).T / temp, dim=1)
    return weighted_mean(-logp.diagonal(0 if rows is None else rows.lo), weights, rows)


class SLMRec(RecModel):
    def __init__(self, config, data):
        super().__init__(config, data)
        d = self.latent_dim = scalar(config["recdim"] or config["embedding_size"], int)
        self.n_layers = scalar(config["layer_num"] or 3, int)
        self.mm_fusion_mode = str(config["mm_fusion_mode"] or "concat")
        self.temp = scalar(config["temp"] or 0.2)
        self.ssl_task = str(config["ssl_task"] or "FAC")
        self.ssl_temp = scalar(config["ssl_temp"] or 0.1)
        self.ssl_alpha = scalar(config["ssl_alpha"] or 0.01)
        self.dropout_rate = scalar(config["dropout_rate"] or 0.3)
        dev = self.device
        self.norm_adj = bipartite_norm_adj(
            data.users.cpu().numpy(), data.items.cpu().numpy(), self.n_users, self.n_items, dev, eps=1e-8
        )
        self.v_feat = l2n(self.v_feat)
        self.t_feat = l2n(self.t_feat)
        self.embedding_user = nn.Parameter(torch.empty(self.n_users, d, device=dev))
        self.embedding_item = nn.Parameter(torch.empty(self.n_items, d, device=dev))
        self.v_dense = nn.Linear(self.v_feat.shape[1], d, device=dev)
        self.t_dense = nn.Linear(self.t_feat.shape[1], d, device=dev)
        fused = d * TOWERS if self.mm_fusion_mode == "concat" else d
        self.user_after = nn.Linear(fused, d, device=dev)
        self.item_after = nn.Linear(fused, d, device=dev)
        for name, div in HEADS:
            setattr(self, name, nn.Linear(d, d // div, device=dev))

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        # the reference xavier-inits the weights only; the biases keep
        # nn.Linear's default
        self.embedding_user.copy_(xavier_uniform(self.embedding_user.shape, generator))
        self.embedding_item.copy_(xavier_uniform(self.embedding_item.shape, generator))
        for module in self.modules():
            if isinstance(module, nn.Linear):
                init_linear(module, generator, init=xavier_uniform)

    def _towers(self):
        return [self.embedding_item, self.v_dense(self.v_feat), self.t_dense(self.t_feat)]

    def _fusion(self, reps):
        if self.mm_fusion_mode == "concat":
            return torch.cat(reps, dim=1)
        return torch.stack(reps).mean(dim=0)

    def _propagate(self, items, keep=None):
        """The towers' LightGCN outputs, one column-batched product a
        layer; ``keep`` (towers of per-layer bool planes) drops after each
        product."""
        d, u = self.latent_dim, self.embedding_user
        x = torch.cat([torch.cat([u, i]) for i in items], dim=1)
        acc = x
        for li in range(self.n_layers):
            x = spmm(self.norm_adj, x)
            if keep is not None:
                x = self._drop(x, [k[li] for k in keep])
            acc = acc + x
        return torch.split(acc / (self.n_layers + 1), d, dim=1)

    def _drop(self, x, masks):
        rate = 1.0 - self.dropout_rate
        return torch.where(torch.cat(masks, dim=1), x / rate, 0.0)

    def _heads(self, reps):
        nu = self.n_users
        user = self.user_after(self._fusion([r[:nu] for r in reps]))
        item = self.item_after(self._fusion([r[nu:] for r in reps]))
        return user, item

    def compute(self):
        """(users, items, the three towers' items)."""
        reps = self._propagate(self._towers())
        user, item = self._heads(reps)
        return user, item, tuple(r[self.n_users :] for r in reps)

    def _view_loss(self, reps1, reps2, users, items, weights, rows=None):
        u1, i1 = self._heads(reps1)
        u2, i2 = self._heads(reps2)
        return in_batch_ce(l2n(u1[users]), l2n(u2[users]), self.ssl_temp, weights, rows) + in_batch_ce(
            l2n(i1[items]), l2n(i2[items]), self.ssl_temp, weights, rows
        )

    def _fac(self, tower_items, idx, weights, rows=None):
        i_i, v_i, t_i = tower_items
        x_i_iv = self.g_i_iv(i_i[idx])
        v_loss = in_batch_ce(x_i_iv, self.g_v_iv(v_i[idx]), self.ssl_temp, weights, rows)
        x_iva_ivat = self.g_iva_ivat(self.g_iv_iva(x_i_iv))
        t_loss = in_batch_ce(x_iva_ivat, self.g_t_ivat(t_i[idx]), self.ssl_temp, weights, rows)
        return v_loss + t_loss

    def _fd(self, keep, users, items, weights, rows=None):
        towers = self._towers()
        return self._view_loss(self._propagate(towers, keep[0]), self._propagate(towers, keep[1]), users, items,
                               weights, rows)

    def _fm(self, fm_idx, keep, users, items, weights, rows=None):
        """Each view zeroes the item side of its drawn modality; view 1
        accumulates view 2's propagated layers and view 2 view 1's."""
        d, u = self.latent_dim, self.embedding_user
        towers = self._towers()
        x1 = torch.cat([torch.cat([u, i * (m != fm_idx[0])]) for i, m in zip(towers, MASK_ID)], dim=1)
        x2 = torch.cat([torch.cat([u, i * (m != fm_idx[1])]) for i, m in zip(towers, MASK_ID)], dim=1)
        e1, e2, acc1, acc2 = x1, x2, x1, x2
        for li in range(self.n_layers):
            e1, e2 = spmm(self.norm_adj, e1), spmm(self.norm_adj, e2)
            if keep is not None:
                e1 = self._drop(e1, [k[li] for k in keep[0]])
                e2 = self._drop(e2, [k[li] for k in keep[1]])
            acc2 = acc2 + e1
            acc1 = acc1 + e2
        reps1 = torch.split(acc1 / (self.n_layers + 1), d, dim=1)
        reps2 = torch.split(acc2 / (self.n_layers + 1), d, dim=1)
        return self._view_loss(reps1, reps2, users, items, weights, rows)

    def draws(self, generator) -> dict:
        """The draws of this ``ssl_task``: FD's and FD+FM's dropout planes,
        FM's and FD+FM's two distinct modality indices."""
        out = {}
        if self.ssl_task in ("FD", "FD+FM"):
            shape = (self.n_users + self.n_items, self.latent_dim)
            mask = lambda: torch.rand(shape, generator=generator, device=self.device) < 1.0 - self.dropout_rate
            out["keep"] = tuple(tuple(tuple(mask() for _ in range(self.n_layers)) for _ in range(TOWERS))
                                for _ in range(2))
        if self.ssl_task in ("FM", "FD+FM"):
            idx1 = torch.randint(0, TOWERS, (), generator=generator, device=self.device)
            idx2 = torch.randint(0, TOWERS - 1, (), generator=generator, device=self.device)
            out["fm_idx"] = (idx1, idx2 + (idx2 >= idx1).to(idx2.dtype))
        return out

    def loss(self, state, batch, generator=None, draws=None):
        """Over a data axis (``batch["rows"]``) the draws, over whole tables
        or of the batch as a whole, are the same on every rank, and every
        in-batch cross-entropy takes every rank's rows as its columns."""
        users, pos, w = batch["users"], batch["pos"], batch["weight"]
        rows = batch.get("rows")
        if draws is None:
            draws = self.draws(generator)
        all_u, all_i, tower_items = self.compute()
        main = in_batch_ce(l2n(all_u[users]), l2n(all_i[pos]), self.temp, w, rows)
        if self.ssl_task == "FAC":
            ssl = self._fac(tower_items, pos, w, rows)
        elif self.ssl_task == "FM":
            ssl = self._fm(draws["fm_idx"], None, users, pos, w, rows)
        elif self.ssl_task == "FD+FM":
            ssl = self._fm(draws["fm_idx"], draws["keep"], users, pos, w, rows)
        else:
            ssl = self._fd(draws["keep"], users, pos, w, rows)
        total = main + self.ssl_alpha * ssl
        return total, (total,)

    def eval_artifacts(self, state):
        return self.compute()[:2]

    def scores_cached(self, state, users, artifacts) -> torch.Tensor:
        all_u, all_i = artifacts
        return torch.sigmoid(all_u[users] @ all_i.T)

    def scores(self, state, users) -> torch.Tensor:
        return self.scores_cached(state, users, self.eval_artifacts(state))
