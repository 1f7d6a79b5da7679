"""GUME: graphs and user modalities enhancement (counterpart of
``genmmrec_tpu/models/gume.py``).

- The modal KNN item graphs (K3's top-k at set-up, "sym" values).
- The user-item graph augmented with item-item edges: each item to the
  other items in both its image and its text KNN lists
  (``common_knn_pairs``, on the device from the two graphs' columns, each
  item's list in ascending order as ``np.intersect1d`` gives it), all
  edges normalized jointly by their counts (D^-½ A D^-½; not symmetric,
  so the backward runs over the transposed CSR); its user-to-item block is
  R.
- Explicit modal embeddings: the gated item-id embedding through the KNN
  graphs, lifted to users by R. Extended embeddings: the id, image and
  text towers through the augmented graph in one column-batched pass
  (``spmm_multi``). An attention separates the modal views, behaviour
  gates integrate them.
- Loss: BPR, two batch-scaled L2 terms, the modal variance/mean
  alignment, the behaviour-modality and user-modality InfoNCE, and the
  contrast of two noise-perturbed copies of the user views.

``forward``'s ``extended_id_override`` replaces the id tower's output (the
RF variant's mixed embeddings). The loss's two noise draws can be passed
(``noise``: four U[0, 1) planes, the integration's two perturbations
then the extended view's, each (n_users, d)), else they are drawn from
the generator.
"""

from __future__ import annotations

import torch
from torch import nn

from genmmrec_tpu_torch.common.init import init_linear, xavier_uniform
from genmmrec_tpu_torch.common.losses import bpr_loss, table_share
from genmmrec_tpu_torch.models.base import RecModel, scalar
from genmmrec_tpu_torch.models.mgcn import batch_l2, infonce, l2n_max
from genmmrec_tpu_torch.ops.graph import knn_graph_sparse, layer_mean, sorted_graph, spmm, spmm_multi


def common_knn_pairs(img_cols: torch.Tensor, txt_cols: torch.Tensor):
    """(rows, cols) of the item pairs (i, j), j ≠ i, with j in both row i
    of ``img_cols`` and row i of ``txt_cols`` ((n, k) neighbour ids, each
    row's ids distinct), by row, each row's columns ascending."""
    n, k = img_cols.shape
    dev = img_cols.device
    own = torch.arange(n, device=dev)[:, None]
    both = (img_cols[:, :, None] == txt_cols[:, None, :]).any(-1) & (img_cols != own)
    cols = torch.sort(torch.where(both, img_cols.long(), n), dim=1).values.reshape(-1)
    keep = cols < n
    return own.expand(n, k).reshape(-1)[keep], cols[keep]


def augmented_adj(users, items, ii_rows, ii_cols, n_users: int, n_items: int):
    """The user-item edges of every train interaction (both directions)
    and the item-item pairs, D^-½ A D^-½ over the edge counts (a node of
    none at 0), in float64 then float32, stably row-sorted; and the
    n_users × n_items R of the user-to-item edges with their values. On the
    edges' device."""
    N = n_users + n_items
    rows = torch.cat([users, items + n_users, ii_rows + n_users])
    cols = torch.cat([items + n_users, users, ii_cols + n_users])
    deg = torch.bincount(rows, minlength=N).to(torch.float64)
    dis = torch.where(deg > 0, deg.clamp(min=1.0).pow(-0.5), 0.0)
    nvals = (dis[rows] * dis[cols]).to(torch.float32)
    srt, order = torch.sort(rows, stable=True)
    adj = sorted_graph(srt, cols[order], nvals[order], N, N)
    u_srt, u_order = torch.sort(users, stable=True)
    R = sorted_graph(u_srt, items[u_order], nvals[: users.shape[0]][u_order], n_users, n_items)
    return adj, R


class GUME(RecModel):
    def __init__(self, config, data):
        super().__init__(config, data)
        self.bm_loss = scalar(config["bm_loss"])
        self.um_loss = scalar(config["um_loss"])
        self.vt_loss = scalar(config["vt_loss"])
        self.reg_weight_1 = scalar(config["reg_weight_1"])
        self.reg_weight_2 = scalar(config["reg_weight_2"])
        self.bm_temp = scalar(config["bm_temp"])
        self.um_temp = scalar(config["um_temp"])
        self.n_ui_layers = scalar(config["n_ui_layers"], int)
        d = self.embedding_dim = scalar(config["embedding_size"], int)
        self.knn_k = scalar(config["knn_k"], int)
        self.n_layers = scalar(config["n_layers"], int)
        self.batch_size = int(config["train_batch_size"])
        dev = self.device
        self.image_original_adj = knn_graph_sparse(self.v_feat, self.knn_k, "sym")
        self.text_original_adj = knn_graph_sparse(self.t_feat, self.knn_k, "sym")
        self.ii_rows, self.ii_cols = common_knn_pairs(
            self.image_original_adj.cols.reshape(self.n_items, self.knn_k),
            self.text_original_adj.cols.reshape(self.n_items, self.knn_k),
        )
        self.norm_adj, self.R = augmented_adj(
            data.users.long(), data.items.long(), self.ii_rows, self.ii_cols, self.n_users, self.n_items
        )
        for name, n in (("user_embedding", self.n_users), ("item_id_embedding", self.n_items),
                        ("extended_image_user", self.n_users), ("extended_text_user", self.n_users)):
            setattr(self, name, nn.Parameter(torch.empty(n, d, device=dev)))
        self.image_reduce = nn.Linear(self.v_feat.shape[1], d, device=dev)
        self.image_trans = nn.Linear(d, d, device=dev)
        self.text_reduce = nn.Linear(self.t_feat.shape[1], d, device=dev)
        self.text_trans = nn.Linear(d, d, device=dev)
        self.separate1 = nn.Linear(d, d, device=dev)
        self.separate2 = nn.Linear(d, 1, bias=False, device=dev)
        self.image_behavior = nn.Linear(d, d, device=dev)
        self.text_behavior = nn.Linear(d, d, device=dev)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        for name in ("user_embedding", "item_id_embedding", "extended_image_user", "extended_text_user"):
            p = getattr(self, name)
            p.copy_(xavier_uniform(p.shape, generator))
        for module in self.modules():
            if isinstance(module, nn.Linear):
                init_linear(module, generator, init=xavier_uniform, zero_bias=True)

    def _conv_ii(self, adj, x):
        for _ in range(self.n_layers):
            x = spmm(adj, x)
        return x

    def explicit_embeds(self):
        """The gated item-id embedding through each modal KNN graph, and the
        same lifted to the users by R over the items: (image items, text
        items, explicit image, explicit text)."""
        img_space = torch.sigmoid(self.image_trans(self.image_reduce(self.v_feat)))
        txt_space = torch.sigmoid(self.text_trans(self.text_reduce(self.t_feat)))
        exp_img_item = self._conv_ii(self.image_original_adj, self.item_id_embedding * img_space)
        exp_txt_item = self._conv_ii(self.text_original_adj, self.item_id_embedding * txt_space)
        exp_img_user, exp_txt_user = spmm_multi(self.R, [exp_img_item, exp_txt_item])
        explicit_image, explicit_text = torch.cat([exp_img_user, exp_img_item]), torch.cat([exp_txt_user, exp_txt_item])
        return exp_img_item, exp_txt_item, explicit_image, explicit_text

    def forward(self, train: bool = False, extended_id_override=None):
        exp_img_item, exp_txt_item, explicit_image, explicit_text = self.explicit_embeds()

        # the three towers share the augmented graph: one batched pass
        d = self.embedding_dim
        x = torch.cat([
            torch.cat([self.user_embedding, self.item_id_embedding]),
            torch.cat([self.extended_image_user, exp_img_item]),
            torch.cat([self.extended_text_user, exp_txt_item]),
        ], dim=1)
        extended_id, extended_image, extended_text = torch.split(layer_mean(self.norm_adj, x, self.n_ui_layers),
                                                                 d, dim=1)
        if extended_id_override is not None:
            extended_id = extended_id_override
        extended_it = (extended_image + extended_text) / 2.0

        sep = lambda v: self.separate2(torch.tanh(self.separate1(v)))
        wgt = torch.softmax(torch.cat([sep(explicit_image), sep(explicit_text)], dim=-1), dim=-1)
        coarse = wgt[:, 0:1] * explicit_image + wgt[:, 1:2] * explicit_text
        fine_img = torch.sigmoid(self.image_behavior(extended_id)) * (explicit_image - coarse)
        fine_txt = torch.sigmoid(self.text_behavior(extended_id)) * (explicit_text - coarse)
        integration = (fine_img + fine_txt + coarse) / 3.0
        all_embeds = extended_id + integration
        if train:
            return all_embeds, (integration, extended_id, extended_it), (explicit_image, explicit_text)
        return all_embeds

    def draws(self, generator):
        """The four U[0, 1) noise planes of the loss's two perturbed pairs."""
        shape = (self.n_users, self.embedding_dim)
        return tuple(torch.rand(shape, generator=generator, device=self.device) for _ in range(4))

    def _noise_cl(self, noise, ids, emb, temp, weights, rows=None):
        perturb = lambda u, x: x + torch.sign(x) * l2n_max(u) * 0.1
        return infonce(perturb(noise[0], emb)[ids], perturb(noise[1], emb)[ids], temp, weights, eps=1e-8, rows=rows)

    def loss(self, state, batch, generator=None, noise=None):
        return self.loss_of(self.forward(train=True), batch, generator, noise)

    def loss_of(self, out, batch, generator=None, noise=None):
        """The loss from ``forward(train=True)``'s output ``out``. Over a data
        axis (``batch["rows"]``) the noise planes, over whole tables, are the
        same on every rank; the modal alignment, over whole tables, is shared;
        the InfoNCE terms take every rank's rows as negatives."""
        users, pos, neg, w = batch["users"], batch["pos"], batch["neg"], batch["weight"]
        rows = batch.get("rows")
        if noise is None:
            noise = self.draws(generator)
        all_e, (integration, extended_id, extended_it), (exp_img, exp_txt) = out
        nu = self.n_users
        u, p_e, n_e = all_e[:nu][users], all_e[nu:][pos], all_e[nu:][neg]
        bpr = bpr_loss((u * p_e).sum(1), (u * n_e).sum(1), w, gamma=0.0, rows=rows)
        reg1 = self.reg_weight_1 * batch_l2(u, p_e, n_e, self.batch_size)
        vt = self.vt_loss * table_share(
            (exp_img.var(correction=0) - exp_txt.var(correction=0)).abs() + (exp_img.mean() - exp_txt.mean()).abs(),
            rows,
        )
        int_u, int_i = integration[:nu], integration[nu:]
        ext_u, ext_i = extended_id[:nu], extended_id[nu:]
        nce = lambda a, b, t: infonce(a, b, t, w, eps=1e-8, rows=rows)
        bm = self.bm_loss * (nce(int_u[users], ext_u[users], self.bm_temp) + nce(int_i[pos], ext_i[pos], self.bm_temp))
        it_u, it_i = extended_it[:nu], extended_it[nu:]
        c_loss = nce(it_u[users], int_u[users], self.um_temp)
        n1 = self._noise_cl(noise[:2], users, int_u, self.um_temp, w, rows)
        n2 = self._noise_cl(noise[2:], users, it_u, self.um_temp, w, rows)
        um = self.um_loss * (c_loss + n1 + n2)
        reg2 = self.reg_weight_2 * 0.5 * (it_i[pos] ** 2).sum() / self.batch_size
        total = bpr + vt + bm + um + reg1 + reg2
        return total, (total,)

    def full_embeddings(self, state):
        all_e = self.forward()
        return all_e[: self.n_users], all_e[self.n_users :]
