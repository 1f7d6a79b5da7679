"""BM3: bootstrap latent representations for multimodal recommendation
(counterpart of ``genmmrec_tpu/models/bm3.py``): LightGCN propagation over
the normalized bipartite adjacency (K1, forward and its symmetric backward)
with the item-id residual, a shared linear predictor, dropout-perturbed
detached targets and weighted cosine bootstrap losses (user↔item,
modality↔item, modality↔its own target). Trainable copies of the feature
tables. It trains without negatives (``use_neg_sampling: False``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from genmmrec_tpu_torch.common.init import init_linear, xavier_normal, xavier_uniform
from genmmrec_tpu_torch.common.losses import emb_loss, table_share, weighted_mean
from genmmrec_tpu_torch.models.base import RecModel, scalar
from genmmrec_tpu_torch.ops.graph import bipartite_norm_adj, spmm

# the targets' dropout masks, in the order the JAX package splits its keys
DROPPED = ("user", "item", "text", "image")


def _cos_loss(a, b, weights, rows=None):
    """1 - cosine(a, b), rows weighted."""
    cos = (F.normalize(a, dim=-1, eps=1e-8) * F.normalize(b, dim=-1, eps=1e-8)).sum(-1)
    return weighted_mean(1.0 - cos, weights, rows)


class BM3(RecModel):
    def __init__(self, config, data):
        super().__init__(config, data)
        d = self.embedding_dim = scalar(config["embedding_size"], int)
        self.n_layers = scalar(config["n_layers"], int)
        self.reg_weight = scalar(config["reg_weight"])
        self.cl_weight = scalar(config["cl_weight"])
        self.dropout = scalar(config["dropout"])
        dev = self.device
        self.norm_adj = bipartite_norm_adj(
            data.users.cpu().numpy(), data.items.cpu().numpy(), self.n_users, self.n_items, dev
        )
        self.user_embedding = nn.Parameter(torch.empty(self.n_users, d, device=dev))
        self.item_id_embedding = nn.Parameter(torch.empty(self.n_items, d, device=dev))
        self.predictor = nn.Linear(d, d, device=dev)
        # the feature tables are trained, from the features (the reference's
        # from_pretrained(freeze=False)); each projected to the embedding width
        if self.v_feat is not None:
            self.image_embedding = nn.Parameter(self.v_feat.clone())
            self.image_trs = nn.Linear(self.v_feat.shape[1], d, device=dev)
        if self.t_feat is not None:
            self.text_embedding = nn.Parameter(self.t_feat.clone())
            self.text_trs = nn.Linear(self.t_feat.shape[1], d, device=dev)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        self.user_embedding.copy_(xavier_uniform(self.user_embedding.shape, generator))
        self.item_id_embedding.copy_(xavier_uniform(self.item_id_embedding.shape, generator))
        init_linear(self.predictor, generator, init=xavier_normal)
        if self.v_feat is not None:
            self.image_embedding.copy_(self.v_feat)
            init_linear(self.image_trs, generator, init=xavier_normal)
        if self.t_feat is not None:
            self.text_embedding.copy_(self.t_feat)
            init_linear(self.text_trs, generator, init=xavier_normal)

    def propagate(self):
        h = self.item_id_embedding
        x = torch.cat([self.user_embedding, h])
        layers = [x]
        for _ in range(self.n_layers):
            x = spmm(self.norm_adj, x)
            layers.append(x)
        out = torch.stack(layers, dim=1).mean(dim=1)
        return out[: self.n_users], out[self.n_users :] + h

    def _drop(self, x, generator, keep):
        """Dropout of a detached target: kept entries scaled by 1/(1-p).
        ``keep`` is the bool mask, else ``U[0, 1) < 1 - p`` from
        ``generator`` (JAX's ``bernoulli``)."""
        if keep is None:
            keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - self.dropout
        return torch.where(keep, x / (1.0 - self.dropout), torch.zeros_like(x))

    def loss(self, state, batch, generator=None, keep=None):
        """``keep``: optional dict of the bool dropout masks by ``DROPPED``
        name, in place of the draws. Over a data axis (``batch["rows"]``)
        the masks, over whole tables, are the same on every rank, and the
        regularizer of the whole tables is shared."""
        keep = keep or {}
        drop = lambda name, x: self._drop(x.detach(), generator, keep.get(name))
        u_online_ori, i_online_ori = self.propagate()
        u_target = drop("user", u_online_ori)
        i_target = drop("item", i_online_ori)
        u_online, i_online = self.predictor(u_online_ori), self.predictor(i_online_ori)

        users, items, w = batch["users"], batch["pos"], batch["weight"]
        rows = batch.get("rows")
        cos = lambda a, b: _cos_loss(a, b, w, rows)
        cl = 0.0
        for name, table, trs in (("text", "text_embedding", "text_trs"), ("image", "image_embedding", "image_trs")):
            if not hasattr(self, table):
                continue
            online = getattr(self, trs)(getattr(self, table))
            target = drop(name, online)
            on = self.predictor(online)[items]
            cl = cl + cos(on, i_target[items]) + cos(on, target[items])

        loss_ui = cos(u_online[users], i_target[items])
        loss_iu = cos(i_online[items], u_target[users])
        reg = table_share(emb_loss(u_online_ori, i_online_ori), rows)
        total = loss_ui + loss_iu + self.reg_weight * reg + self.cl_weight * cl
        return total, (total,)

    def full_embeddings(self, state):
        u_online, i_online = self.propagate()
        return self.predictor(u_online), self.predictor(i_online)
