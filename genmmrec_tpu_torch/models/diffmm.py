"""DiffMM: modality-aware graph diffusion recommendation, serving half.

Counterpart of ``genmmrec_tpu/models/diffmm.py``: the modal feature
transforms, ``forward_MM`` over the normalized adjacency and the two
regenerated modal user-item graphs, the per-modality denoisers, the
reverse-diffusion of users' interaction vectors, and the static-nnz
rebuild of the modal graphs. The losses (BPR, InfoNCE, diffusion) come
with training.

Parameter names follow the JAX pytree ``{"rec": {uEmbeds, iEmbeds,
modal_weight, image_trans, text_trans}, "denoise_image", "denoise_text"}``
with the ``rec`` level dropped (``genmmrec_tpu_torch.interop``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from genmmrec_tpu_torch.common.init import xavier_uniform
from genmmrec_tpu_torch.models.base import RecModel, scalar
from genmmrec_tpu_torch.models.diffusion.dnn import Denoise
from genmmrec_tpu_torch.models.diffusion.sampler import p_sample_loop
from genmmrec_tpu_torch.models.diffusion.schedule import make_schedule
from genmmrec_tpu_torch.ops.graph import (
    SparseGraph,
    bipartite_norm_adj,
    sorted_graph,
    spmm,
    spmm_multi,
)


def _l2norm(x, eps=1e-12):
    return F.normalize(x, dim=-1, eps=eps)


class DiffMM(RecModel):
    def __init__(self, config, data):
        super().__init__(config, data)
        self.latdim = scalar(config["embedding_size"], int)
        self.gnn_layer = scalar(config["n_layers"], int)
        self.keep_rate = scalar(config["keep_rate"])
        self.trans = scalar(config["trans_type"], int)
        self.ris_adj_lambda = scalar(config["ris_adj_lambda"])
        self.ris_lambda = scalar(config["ris_lambda"])
        self.steps = scalar(config["steps"], int)
        self.sampling_steps = scalar(config["sampling_steps"] or 0, int)
        self.sampling_noise = bool(config["sampling_noise"])
        self.rebuild_k = scalar(config["rebuild_k"], int)
        self.d_emb_size = scalar(config["d_emb_size"], int)
        self.norm = bool(config["norm"])

        self.norm_adj = bipartite_norm_adj(
            data.users.cpu().numpy(), data.items.cpu().numpy(),
            self.n_users, self.n_items, self.device,
        )
        self.sched = make_schedule(
            "linear-var",
            scalar(config["noise_scale"]),
            scalar(config["noise_min"]),
            scalar(config["noise_max"]),
            self.steps,
            device=self.device,
            beta_fixed_value=0.0001,
        )
        dims = config["dims"] if isinstance(config["dims"], list) else [config["dims"]]
        self.out_dims = list(dims) + [self.n_items]
        self.in_dims = self.out_dims[::-1]
        self.image_feat_dim = self.v_feat.shape[1] if self.v_feat is not None else 0
        self.text_feat_dim = self.t_feat.shape[1] if self.t_feat is not None else 0

        empty = lambda *shape: nn.Parameter(torch.empty(*shape, device=self.device))
        self.uEmbeds = empty(self.n_users, self.latdim)
        self.iEmbeds = empty(self.n_items, self.latdim)
        self.modal_weight = empty(2)
        # trans_type 0: both modalities a matrix + leaky_relu; 1: both linear;
        # 2: image matrix, text linear
        if self.trans == 1:
            self.image_trans = nn.Linear(self.image_feat_dim, self.latdim, device=self.device)
        else:
            self.image_trans = empty(self.image_feat_dim, self.latdim)
        if self.trans == 0:
            self.text_trans = empty(self.text_feat_dim, self.latdim)
        else:
            self.text_trans = nn.Linear(self.text_feat_dim, self.latdim, device=self.device)
        make_dnn = lambda: Denoise(self.in_dims, self.out_dims, self.d_emb_size, self.norm).to(self.device)
        self.denoise_image = make_dnn()
        self.denoise_text = make_dnn()

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """xavier-uniform embeddings and transforms, zero linear biases,
        equal modal weights, and the denoisers' own init; all drawn from
        ``generator``."""
        self.uEmbeds.copy_(xavier_uniform(self.uEmbeds.shape, generator))
        self.iEmbeds.copy_(xavier_uniform(self.iEmbeds.shape, generator))
        self.modal_weight.fill_(0.5)
        for trans in (self.image_trans, self.text_trans):
            if isinstance(trans, nn.Linear):
                trans.weight.copy_(xavier_uniform(trans.weight.shape, generator))
                trans.bias.zero_()
            else:
                trans.copy_(xavier_uniform(trans.shape, generator))
        self.denoise_image.init_params(generator)
        self.denoise_text.init_params(generator)

    def get_image_feats(self):
        if self.trans in (0, 2):
            return F.leaky_relu(self.v_feat @ self.image_trans, 0.2)
        return self.image_trans(self.v_feat)

    def get_text_feats(self):
        if self.trans == 0:
            return F.leaky_relu(self.t_feat @ self.text_trans, 0.2)
        return self.text_trans(self.t_feat)

    def forward_MM(self, state) -> Tuple[torch.Tensor, torch.Tensor]:
        image_feats = self.get_image_feats()
        text_feats = self.get_text_feats()
        weight = torch.softmax(self.modal_weight, dim=0)
        adj = self.norm_adj
        ego = torch.cat([self.uEmbeds, self.iEmbeds])
        e_img_adj = spmm(state["image_ui"], ego)
        e_txt_adj = spmm(state["text_ui"], ego)
        # the two main-adjacency towers propagate together at d = 2·latdim
        e_img, e_txt = spmm_multi(
            adj,
            [
                torch.cat([self.uEmbeds, _l2norm(image_feats)]),
                torch.cat([self.uEmbeds, _l2norm(text_feats)]),
            ],
        )
        e_img_, e_txt_ = spmm_multi(
            adj,
            [
                torch.cat([e_img[: self.n_users], self.iEmbeds]),
                torch.cat([e_txt[: self.n_users], self.iEmbeds]),
            ],
        )
        embedsImage = e_img + e_img_ + self.ris_adj_lambda * e_img_adj
        embedsText = e_txt + e_txt_ + self.ris_adj_lambda * e_txt_adj
        embedsModal = weight[0] * embedsImage + weight[1] * embedsText

        embeds = embedsModal
        acc = embeds
        for _ in range(self.gnn_layer):
            embeds = spmm(adj, embeds)
            acc = acc + embeds
        out = acc + self.ris_lambda * _l2norm(embedsModal)
        return out[: self.n_users], out[self.n_users :]

    def full_embeddings(self, state):
        return self.forward_MM(state)

    # -- diffusion phase (driven by DiffMMTrainer.regenerate) ------------
    def interaction_vectors(self, users: torch.Tensor) -> torch.Tensor:
        """(B, n_items) 0/1 rows of the users' train items. The history pads
        with ``n_items``: scatter into one spare column and drop it."""
        h = self.data.hist[users]
        x = torch.zeros(users.shape[0], self.n_items + 1, device=h.device)
        return x.scatter_(1, h, 1.0)[:, : self.n_items]

    def p_sample_users(self, denoiser: Denoise, x_start, generator=None):
        """Reverse-diffuse interaction vectors with the eval-mode denoiser."""
        return p_sample_loop(
            self.sched, denoiser, x_start, self.sampling_steps,
            generator=generator, sampling_noise=self.sampling_noise,
        )

    def rebuild_ui_graph(self, topk_items: torch.Tensor, generator=None) -> SparseGraph:
        """Static-nnz regenerated graph: symmetrized top-k user-item edges
        plus self loops, symmetric-normalized, with paired ``keep_rate``
        edge dropout, row-sorted by a stable sort (the JAX package's edge
        order)."""
        U, k = topk_items.shape
        N = self.n_users + self.n_items
        dev = topk_items.device
        u_nodes = torch.arange(U, device=dev).repeat_interleave(k)
        i_nodes = topk_items.reshape(-1).to(torch.int64) + self.n_users
        loops = torch.arange(N, device=dev)
        rows = torch.cat([u_nodes, i_nodes, loops])
        cols = torch.cat([i_nodes, u_nodes, loops])
        deg = torch.bincount(rows, minlength=N).to(torch.float32)
        dis = torch.where(deg > 0, deg.pow(-0.5), torch.zeros_like(deg))
        vals = dis[rows] * dis[cols]
        if self.keep_rate < 1.0:
            # one mask per undirected user-item edge, applied to both
            # directions, so the graph stays value-symmetric
            if generator is None:
                raise ValueError("edge dropout needs a generator")
            draw = lambda n: torch.rand(n, generator=generator, device=dev) < self.keep_rate
            m_ui = draw(U * k)
            mask = torch.cat([m_ui, m_ui, draw(N)])
            vals = torch.where(mask, vals / self.keep_rate, torch.zeros_like(vals))
        rows, order = torch.sort(rows, stable=True)
        return sorted_graph(rows, cols[order], vals[order], N, N, symmetric=True)

    def init_state(self, generator=None) -> dict:
        """Self-loop-only graphs until the first regeneration."""
        topk0 = torch.zeros(self.n_users, self.rebuild_k, dtype=torch.int64, device=self.device)
        g = self.rebuild_ui_graph(topk0, generator)
        vals = torch.where(g.rows == g.cols, g.vals, torch.zeros_like(g.vals))
        g = sorted_graph(g.rows, g.cols, vals, g.n_rows, g.n_cols, symmetric=True)
        return {"image_ui": g, "text_ui": g}
