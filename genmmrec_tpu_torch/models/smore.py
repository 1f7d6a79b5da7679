"""SMORE: spectrum-based modality fusion (counterpart of
``genmmrec_tpu/models/smore.py``). MGCN's skeleton (``sym_ui_adj``, the
modal KNN graphs lifted to users by R, the InfoNCE of side against
content) plus:

- spectrum convolution: the projected features' ``rfft`` over the
  embedding axis (``norm="ortho"``) times a learned complex weight, and
  back by ``irfft``, for each modality and for their product (the fusion).
  Each weight is stored as (1, d/2+1, 2) real and imaginary parts, the JAX
  package's layout;
- a fusion item graph (``max_pool_fusion``): the union of the image
  (``image_knn_k``) and text (``text_knn_k``) KNN graphs, a pair in both at
  the larger of its two values, built on the device and row-sorted by
  (row, column);
- softmax queries over the fusion view scale the modal views; preference
  gates of the content view, each through dropout in training, scale the
  three; their mean is the side view.

The three dropout masks can be passed to ``loss`` (``keep``: three bool
(N, d) planes, image, text, fusion), else they are drawn from the
generator.
"""

from __future__ import annotations

import torch
from torch import nn

from genmmrec_tpu_torch.common.init import init_linear, normal, xavier_uniform
from genmmrec_tpu_torch.common.losses import bpr_loss
from genmmrec_tpu_torch.models.base import RecModel, scalar
from genmmrec_tpu_torch.models.mgcn import batch_l2, infonce, sym_ui_adj
from genmmrec_tpu_torch.ops.graph import SparseGraph, knn_graph_sparse, layer_mean, sorted_graph, spmm, spmm_multi

PREFERS = ("image", "text", "fusion")


def max_pool_fusion(a: SparseGraph, b: SparseGraph) -> SparseGraph:
    """The union of two square graphs' edges, each pair once at the larger
    of its values, sorted by (row, column), on their device."""
    n = a.n_rows
    keys = torch.cat([a.rows.long() * n + a.cols.long(), b.rows.long() * n + b.cols.long()])
    vals = torch.cat([a.vals, b.vals])
    uniq, inv = torch.unique(keys, sorted=True, return_inverse=True)
    out = torch.full((uniq.shape[0],), -torch.inf, device=vals.device).scatter_reduce(
        0, inv, vals, "amax", include_self=True
    )
    return sorted_graph(uniq // n, uniq % n, out, n, n)


class _Query(nn.Module):
    def __init__(self, d: int, device):
        super().__init__()
        self.l1 = nn.Linear(d, d, device=device)
        self.l2 = nn.Linear(d, d, bias=False, device=device)

    def forward(self, x):
        return self.l2(torch.tanh(self.l1(x)))


class SMORE(RecModel):
    def __init__(self, config, data):
        super().__init__(config, data)
        self.cl_loss = scalar(config["cl_loss"])
        self.n_ui_layers = scalar(config["n_ui_layers"], int)
        d = self.embedding_dim = scalar(config["embedding_size"], int)
        self.n_layers = scalar(config["n_layers"], int)
        self.reg_weight = scalar(config["reg_weight"])
        self.image_knn_k = scalar(config["image_knn_k"] or 10, int)
        self.text_knn_k = scalar(config["text_knn_k"] or 10, int)
        self.dropout_rate = scalar(config["dropout_rate"] or 0.0)
        self.batch_size = int(config["train_batch_size"])
        dev = self.device
        users, items = data.users.cpu().numpy(), data.items.cpu().numpy()
        self.norm_adj, self.R = sym_ui_adj(users, items, self.n_users, self.n_items, dev)
        self.image_original_adj = knn_graph_sparse(self.v_feat, self.image_knn_k, "sym")
        self.text_original_adj = knn_graph_sparse(self.t_feat, self.text_knn_k, "sym")
        self.fusion_adj = max_pool_fusion(self.image_original_adj, self.text_original_adj)
        self.user_embedding = nn.Parameter(torch.empty(self.n_users, d, device=dev))
        self.item_id_embedding = nn.Parameter(torch.empty(self.n_items, d, device=dev))
        self.image_trs = nn.Linear(self.v_feat.shape[1], d, device=dev)
        self.text_trs = nn.Linear(self.t_feat.shape[1], d, device=dev)
        self.query_v = _Query(d, dev)
        self.query_t = _Query(d, dev)
        for name in ("gate_v", "gate_t", "gate_f") + tuple(f"gate_{m}_prefer" for m in PREFERS):
            setattr(self, name, nn.Linear(d, d, device=dev))
        for m in PREFERS:
            setattr(self, f"{m}_complex_weight", nn.Parameter(torch.empty(1, d // 2 + 1, 2, device=dev)))

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        self.user_embedding.copy_(xavier_uniform(self.user_embedding.shape, generator))
        self.item_id_embedding.copy_(xavier_uniform(self.item_id_embedding.shape, generator))
        for module in self.modules():
            if isinstance(module, nn.Linear):
                init_linear(module, generator, init=xavier_uniform, zero_bias=True)
        for m in PREFERS:
            w = getattr(self, f"{m}_complex_weight")
            w.copy_(normal(w.shape, 1.0, generator))

    def _spectrum(self, image_feats, text_feats):
        d = image_feats.shape[1]
        weight = lambda m: torch.view_as_complex(getattr(self, f"{m}_complex_weight").contiguous())
        img = torch.fft.rfft(image_feats, dim=1, norm="ortho")
        txt = torch.fft.rfft(text_feats, dim=1, norm="ortho")
        back = lambda z: torch.fft.irfft(z, n=d, dim=1, norm="ortho")
        return back(img * weight("image")), back(txt * weight("text")), back(txt * img * weight("fusion"))

    def draws(self, generator):
        """The three preference dropout masks the loss reads."""
        shape = (self.n_users + self.n_items, self.embedding_dim)
        return tuple(torch.rand(shape, generator=generator, device=self.device) < 1.0 - self.dropout_rate
                     for _ in PREFERS)

    def forward(self, train: bool = False, keep=None):
        gate = lambda layer, x: torch.sigmoid(layer(x))
        image_conv, text_conv, fusion_conv = self._spectrum(self.image_trs(self.v_feat), self.text_trs(self.t_feat))
        image_item = self.item_id_embedding * gate(self.gate_v, image_conv)
        text_item = self.item_id_embedding * gate(self.gate_t, text_conv)
        fusion_item = self.item_id_embedding * gate(self.gate_f, fusion_conv)
        content = layer_mean(self.norm_adj, torch.cat([self.user_embedding, self.item_id_embedding]),
                             self.n_ui_layers)
        for _ in range(self.n_layers):
            image_item = spmm(self.image_original_adj, image_item)
        for _ in range(self.n_layers):
            text_item = spmm(self.text_original_adj, text_item)
        for _ in range(self.n_layers):
            fusion_item = spmm(self.fusion_adj, fusion_item)
        img_u, txt_u, fus_u = spmm_multi(self.R, [image_item, text_item, fusion_item])
        image_embeds = torch.cat([img_u, image_item])
        text_embeds = torch.cat([txt_u, text_item])
        fusion_embeds = torch.cat([fus_u, fusion_item])
        agg_image = torch.softmax(self.query_v(fusion_embeds), dim=-1) * image_embeds
        agg_text = torch.softmax(self.query_t(fusion_embeds), dim=-1) * text_embeds
        prefer = [gate(getattr(self, f"gate_{m}_prefer"), content) for m in PREFERS]
        if keep is not None and self.dropout_rate > 0:
            rate = 1.0 - self.dropout_rate
            prefer = [torch.where(k, p / rate, 0.0) for k, p in zip(keep, prefer)]
        side = (prefer[0] * agg_image + prefer[1] * agg_text + prefer[2] * fusion_embeds) / 3.0
        all_e = content + side
        u, i = all_e[: self.n_users], all_e[self.n_users :]
        return (u, i, side, content) if train else (u, i)

    def loss(self, state, batch, generator=None, keep=None):
        users, pos, neg, w = batch["users"], batch["pos"], batch["neg"], batch["weight"]
        if keep is None and self.dropout_rate > 0:
            keep = self.draws(generator)
        rows = batch.get("rows")
        ua, ia, side, content = self.forward(train=True, keep=keep)
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
