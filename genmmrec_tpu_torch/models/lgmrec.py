"""LGMRec: local and global (hypergraph) multimodal embeddings
(counterpart of ``genmmrec_tpu/models/lgmrec.py``).

- CGE: LightGCN over the symmetric D^-½ A D^-½ adjacency of the unique
  pairs (``bipartite_norm_adj``, K1 forward and backward on the same
  edges).
- MGE: each modality's raw features times a projection, the users' the
  mean over their items (R, unit values, over each user's unique-item
  count), then ``n_mm_layers`` hops of the adjacency; row-normalized and
  summed with CGE.
- Hypergraph: each modality's items and users (R times the item logits)
  assigned to ``hyper_num`` hyperedges by a Gumbel softmax (τ = 0.2), the
  assignments through a ``keep_rate`` dropout, ``n_hyper_layer`` rounds of
  item → hyperedge → item/user; added, row-normalized, times ``alpha``.
- Loss: BPR, ``cl_weight`` times the sum-reduced hypergraph InfoNCE over
  all users and items (the full (B, n) logits), ``reg_weight`` times the
  embeddings' norms.

Every draw can be passed (``draws``: ``gumbel``, four U[0, 1) planes for
the item and user logits of the image then the text modality, and
``keep``, four bool planes of the same shapes); what is not passed is
drawn from the generator. The forward draws at evaluation too, as the JAX
package does with a fixed key: ``full_embeddings`` takes a generator
seeded 0 unless it is given the draws.
"""

from __future__ import annotations

import torch
from torch import nn

from genmmrec_tpu_torch.common.init import xavier_uniform
from genmmrec_tpu_torch.common.losses import bpr_loss, emb_loss
from genmmrec_tpu_torch.common.norm import l2n
from genmmrec_tpu_torch.models.base import RecModel, scalar
from genmmrec_tpu_torch.ops.graph import bipartite_norm_adj, interaction_matrix, layer_mean, spmm, unique_ui_pairs

TAU = 0.2


class LGMRec(RecModel):
    def __init__(self, config, data):
        super().__init__(config, data)
        d = self.embedding_dim = scalar(config["embedding_size"], int)
        self.feat_embed_dim = scalar(config["feat_embed_dim"], int)
        self.n_mm_layer = scalar(config["n_mm_layers"], int)
        self.n_ui_layers = scalar(config["n_ui_layers"], int)
        self.n_hyper_layer = scalar(config["n_hyper_layer"], int)
        self.hyper_num = scalar(config["hyper_num"], int)
        self.keep_rate = scalar(config["keep_rate"])
        self.alpha = scalar(config["alpha"])
        self.cl_weight = scalar(config["cl_weight"])
        self.reg_weight = scalar(config["reg_weight"])
        dev = self.device
        users, items = data.users.cpu().numpy(), data.items.cpu().numpy()
        self.norm_adj = bipartite_norm_adj(users, items, self.n_users, self.n_items, dev)
        self.adj = interaction_matrix(users, items, self.n_users, self.n_items, dev)
        uu, _ = unique_ui_pairs(users, items)
        deg_u = torch.bincount(torch.as_tensor(uu), minlength=self.n_users).to(torch.float32)
        self.inv_inters_u = (1.0 / (deg_u + 1e-7)).to(dev)
        self.user_embedding = nn.Parameter(torch.empty(self.n_users, d, device=dev))
        self.item_id_embedding = nn.Parameter(torch.empty(self.n_items, d, device=dev))
        for m, h, feats in (("image", "v", self.v_feat), ("text", "t", self.t_feat)):
            setattr(self, f"item_{m}_trs", nn.Parameter(torch.empty(feats.shape[1], self.feat_embed_dim, device=dev)))
            setattr(self, f"{h}_hyper", nn.Parameter(torch.empty(feats.shape[1], self.hyper_num, device=dev)))

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        for p in self.parameters():
            p.copy_(xavier_uniform(p.shape, generator))

    def _mge(self, feats, trs):
        item_feats = feats @ trs
        user_feats = spmm(self.adj, item_feats) * self.inv_inters_u[:, None]
        x = torch.cat([user_feats, item_feats])
        for _ in range(self.n_mm_layer):
            x = spmm(self.norm_adj, x)
        return x

    @staticmethod
    def _gumbel_softmax(uniform, logits):
        g = -torch.log(-torch.log(uniform + 1e-20) + 1e-20)
        return torch.softmax((logits + g) / TAU, dim=1)

    def _hgnn(self, i_hyper, u_hyper, embeds):
        i_ret, u_ret = embeds, None
        for _ in range(self.n_hyper_layer):
            lat = i_hyper.T @ i_ret
            i_ret = i_hyper @ lat
            u_ret = u_hyper @ lat
        return u_ret, i_ret

    def draws(self, generator):
        """Every draw the forward reads: the Gumbel uniforms and the keep
        masks of the image items, image users, text items, text users."""
        shapes = [(n, self.hyper_num) for n in (self.n_items, self.n_users)] * 2
        rand = lambda s: torch.rand(s, generator=generator, device=self.device)
        return dict(gumbel=tuple(rand(s) for s in shapes), keep=tuple(rand(s) < self.keep_rate for s in shapes))

    def forward(self, draws):
        gumbel, keep = draws["gumbel"], draws["keep"]
        drop = (lambda m, x: torch.where(m, x / self.keep_rate, 0.0)) if self.keep_rate < 1.0 else (lambda m, x: x)
        hyper = []
        for j, (feats, w) in enumerate(((self.v_feat, self.v_hyper), (self.t_feat, self.t_hyper))):
            i_logits = feats @ w
            u_logits = spmm(self.adj, i_logits)
            hyper.append((drop(keep[2 * j], self._gumbel_softmax(gumbel[2 * j], i_logits)),
                          drop(keep[2 * j + 1], self._gumbel_softmax(gumbel[2 * j + 1], u_logits))))
        cge = layer_mean(self.norm_adj, torch.cat([self.user_embedding, self.item_id_embedding]), self.n_ui_layers)
        mge = l2n(self._mge(self.v_feat, self.item_image_trs)) + l2n(self._mge(self.t_feat, self.item_text_trs))
        lge = cge + mge
        item_cge = cge[self.n_users :]
        uv_e, iv_e = self._hgnn(*hyper[0], item_cge)
        ut_e, it_e = self._hgnn(*hyper[1], item_cge)
        ghe = torch.cat([uv_e, iv_e]) + torch.cat([ut_e, it_e])
        all_embs = lge + self.alpha * l2n(ghe)
        return all_embs[: self.n_users], all_embs[self.n_users :], (uv_e, iv_e, ut_e, it_e)

    @staticmethod
    def _ssl_triple(e1, e2, all_e, weights):
        n1, n2, na = l2n(e1), l2n(e2), l2n(all_e)
        pos = torch.exp((n1 * n2).sum(1) / TAU)
        ttl = torch.exp(n1 @ na.T / TAU).sum(1)
        return -(torch.log(pos / ttl) * weights).sum()

    def loss(self, state, batch, generator=None, draws=None):
        users, pos, neg, w = batch["users"], batch["pos"], batch["neg"], batch["weight"]
        rows = batch.get("rows")
        # over a data axis the draws, over whole tables, are the same on every
        # rank, and the contrast's terms are sums over the batch's rows
        ua, ia, (uv_e, iv_e, ut_e, it_e) = self.forward(draws if draws is not None else self.draws(generator))
        u, p_e, n_e = ua[users], ia[pos], ia[neg]
        bpr = bpr_loss((u * p_e).sum(1), (u * n_e).sum(1), w, gamma=0.0, rows=rows)
        hcl = self._ssl_triple(uv_e[users], ut_e[users], ut_e, w) + self._ssl_triple(iv_e[pos], it_e[pos], it_e, w)
        total = bpr + self.cl_weight * hcl + self.reg_weight * emb_loss(u, p_e, n_e, rows=rows)
        return total, (total,)

    def full_embeddings(self, state, draws=None):
        if draws is None:
            draws = self.draws(torch.Generator(device=self.device).manual_seed(0))
        ua, ia, _ = self.forward(draws)
        return ua, ia
