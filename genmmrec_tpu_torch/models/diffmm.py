"""DiffMM: modality-aware graph diffusion recommendation.

Counterpart of ``genmmrec_tpu/models/diffmm.py``: the modal feature
transforms, ``forward_MM`` over the normalized adjacency and the two
regenerated modal user-item graphs, the training forward ``_forward_joint``
with its contrastive towers, the BPR + InfoNCE loss, the per-modality
denoisers with their SNR-weighted diffusion loss, the reverse-diffusion of
users' interaction vectors, and the static-nnz rebuild of the modal graphs.

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
from genmmrec_tpu_torch.common.losses import exp_denominator_streamed
from genmmrec_tpu_torch.data.arrays import interaction_vectors
from genmmrec_tpu_torch.models.base import RecModel, scalar
from genmmrec_tpu_torch.models.diffusion.dnn import Denoise
from genmmrec_tpu_torch.models.diffusion.sampler import p_sample_loop
from genmmrec_tpu_torch.models.diffusion.schedule import make_schedule, q_sample, snr
from genmmrec_tpu_torch.ops.graph import (
    SparseGraph,
    bipartite_norm_adj,
    placeholder_ui_graph,
    regenerated_ui_graph,
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
        self.cl_method = scalar(config["cl_method"], int)
        self.ssl_reg = scalar(config["ssl_reg"])
        self.temp = scalar(config["temperature"])
        self.reg_weight = scalar(config["reg_weight"])
        self.e_loss = scalar(config["e_loss"])
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

    def param_groups(self) -> dict:
        """The main optimizer trains ``rec``; each denoiser has its own Adam
        (the JAX package's ``param_labels``)."""
        dn = {"denoise_image": list(self.denoise_image.parameters()),
              "denoise_text": list(self.denoise_text.parameters())}
        taken = {id(p) for ps in dn.values() for p in ps}
        return {"rec": [p for p in self.parameters() if id(p) not in taken], **dn}

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

    def _forward_joint(self, state):
        """``forward_MM`` and the two contrastive towers with batched
        propagations: each modal graph is touched once at d = 2·latdim (the
        main branch's ego and its CL tower), and each main-adjacency layer
        carries the rec tower and both CL towers in one d = 3·latdim pass."""
        adj = self.norm_adj
        weight = torch.softmax(self.modal_weight, dim=0)
        ego = torch.cat([self.uEmbeds, self.iEmbeds])
        u_img = torch.cat([self.uEmbeds, _l2norm(self.get_image_feats())])
        u_txt = torch.cat([self.uEmbeds, _l2norm(self.get_text_feats())])

        e_img_adj, cl1 = spmm_multi(state["image_ui"], [ego, u_img])
        e_txt_adj, cl2 = spmm_multi(state["text_ui"], [ego, u_txt])
        e_img, e_txt = spmm_multi(adj, [u_img, u_txt])
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

        rec_e, acc = embedsModal, embedsModal
        acc1, acc2 = cl1, cl2
        for _ in range(self.gnn_layer):
            rec_e, cl1, cl2 = spmm_multi(adj, [rec_e, cl1, cl2])
            acc = acc + rec_e
            acc1 = acc1 + cl1
            acc2 = acc2 + cl2
        out = acc + self.ris_lambda * _l2norm(embedsModal)
        nu = self.n_users
        return out[:nu], out[nu:], acc1[:nu], acc1[nu:], acc2[:nu], acc2[nu:]

    def contrast_loss(self, e1, e2, nodes, weights):
        """InfoNCE of ``e1[nodes]`` against every row of ``e2``."""
        e1 = _l2norm(e1 + 1e-8)
        e2 = _l2norm(e2 + 1e-8)
        p1, p2 = e1[nodes], e2[nodes]
        nume = torch.exp((p1 * p2).sum(-1) / self.temp)
        # the (B, N) denominator in one shot up to 256 MB, streamed past it
        if p1.shape[0] * e2.shape[0] * 4 > 256 * 1024 * 1024:
            deno = exp_denominator_streamed(p1, e2, self.temp)
        else:
            deno = torch.exp(p1 @ e2.T / self.temp).sum(-1)
        per = -torch.log(nume / deno)
        return (per * weights).sum() / weights.sum().clamp(min=1.0)

    def loss(self, state, batch, generator=None):
        """BPR over (user, pos, neg) + L2 on the full embedding tables +
        ``ssl_reg``·InfoNCE between the views that ``cl_method`` picks."""
        users, pos, neg, w = batch["users"], batch["pos"], batch["neg"], batch["weight"]
        usrEmbeds, itmEmbeds, u1, i1, u2, i2 = self._forward_joint(state)
        anc, posE, negE = usrEmbeds[users], itmEmbeds[pos], itmEmbeds[neg]
        pos_s = (anc * posE).sum(1)
        neg_s = (anc * negE).sum(1)
        bpr = -(torch.log(1e-10 + torch.sigmoid(pos_s - neg_s)) * w).sum() / w.sum().clamp(min=1.0)
        reg = ((self.uEmbeds**2).sum() + (self.iEmbeds**2).sum()) * self.reg_weight
        if self.cl_method == 1:
            cl = (
                self.contrast_loss(usrEmbeds, u1, users, w)
                + self.contrast_loss(itmEmbeds, i1, pos, w)
                + self.contrast_loss(usrEmbeds, u2, users, w)
                + self.contrast_loss(itmEmbeds, i2, pos, w)
            ) * self.ssl_reg
        else:
            cl = (self.contrast_loss(u1, u2, users, w) + self.contrast_loss(i1, i2, pos, w)) * self.ssl_reg
        total = bpr + reg + cl
        return total, (total,)

    def diffusion_losses(
        self, denoiser: Denoise, x_start, item_embeds, modal_feats, ts=None, noise=None, keep=None, generator=None
    ):
        """Per-user SNR-weighted diffusion MSE and modal-alignment loss.

        ``ts``, ``noise`` and the dropout ``keep`` mask are drawn from
        ``generator`` unless given."""
        B = x_start.shape[0]
        dev = x_start.device
        if ts is None:
            ts = torch.randint(0, self.steps, (B,), generator=generator, device=dev)
        if noise is None:
            noise = torch.randn(x_start.shape, generator=generator, device=dev)
        x_t = q_sample(self.sched, x_start, ts, noise)
        model_output = denoiser(x_t, ts, dropout=0.5, keep=keep, generator=generator)
        mse = ((x_start - model_output) ** 2).mean(dim=1)
        weight = torch.where(ts == 0, 1.0, snr(self.sched, ts - 1) - snr(self.sched, ts))
        diff_loss = weight * mse
        usr_model_embeds = model_output @ modal_feats
        usr_id_embeds = x_start @ item_embeds
        gc_loss = ((usr_model_embeds - usr_id_embeds) ** 2).mean(dim=1)
        return diff_loss, gc_loss

    def full_embeddings(self, state):
        return self.forward_MM(state)

    # -- diffusion phases (driven by DiffMMTrainer) -----------------------
    def interaction_vectors(self, users: torch.Tensor) -> torch.Tensor:
        return interaction_vectors(self.data, users)

    def p_sample_users(self, denoiser: Denoise, x_start, generator=None):
        """Reverse-diffuse interaction vectors with the eval-mode denoiser."""
        return p_sample_loop(
            self.sched, denoiser, x_start, self.sampling_steps,
            generator=generator, sampling_noise=self.sampling_noise,
        )

    def rebuild_ui_graph(self, topk_items: torch.Tensor, generator=None) -> SparseGraph:
        """The regenerated modal graph of ``topk_items`` (``regenerated_ui_graph``)."""
        return regenerated_ui_graph(topk_items, self.n_users, self.n_items, self.keep_rate, generator)

    def init_state(self, generator=None) -> dict:
        """Self-loop-only graphs until the first regeneration."""
        g = placeholder_ui_graph(self.n_users, self.n_items, self.rebuild_k, self.keep_rate, self.device, generator)
        return {"image_ui": g, "text_ui": g}
