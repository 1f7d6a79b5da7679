"""DiffMM: modality-aware graph diffusion recommendation.

Counterpart of ``genmmrec_tpu/models/diffmm.py``: the modal feature
transforms, ``forward_MM`` over the normalized adjacency and the two
regenerated modal user-item graphs, the training forward ``_forward_joint``
with its contrastive towers, the BPR + InfoNCE loss, the per-modality
denoisers with their SNR-weighted diffusion loss, the reverse-diffusion of
users' interaction vectors, and the static-nnz rebuild of the modal graphs.

With ``remat`` (the ``remat_gcn`` key; absent, on past 100,000 nodes, as
in the JAX package) the training forward's two propagation regions, the
modal passes and each main-adjacency layer, run under
``torch.utils.checkpoint`` and are recomputed in the backward (K1 or K2
launched again). ``_Spmm`` keeps only the graph for its backward, so the
regions hold little that a recompute could free.

Parameter names follow the JAX pytree ``{"rec": {uEmbeds, iEmbeds,
modal_weight, image_trans, text_trans}, "denoise_image", "denoise_text"}``
with the ``rec`` level dropped (``genmmrec_tpu_torch.interop``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from genmmrec_tpu_torch.common.init import xavier_uniform
from genmmrec_tpu_torch.common.losses import exp_denominator_streamed, table_share
from genmmrec_tpu_torch.data.arrays import interaction_vectors
from genmmrec_tpu_torch.models.base import RecModel, scalar
from genmmrec_tpu_torch.models.diffusion.dnn import Denoise
from genmmrec_tpu_torch.models.diffusion.sampler import chain_noise, p_sample_loop
from genmmrec_tpu_torch.models.diffusion.schedule import make_schedule, q_sample, snr
from genmmrec_tpu_torch.ops.graph import (
    SparseGraph,
    bipartite_norm_adj,
    placeholder_ui_graph,
    regenerated_ui_graph,
    spmm,
    spmm_multi,
)
from genmmrec_tpu_torch.parallel import mesh as pm


# past this many nodes (users + items) ``remat`` is on by default
REMAT_NODES = 100_000


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
        # the JAX package's rule: recompute the propagation in the backward
        # past 100,000 nodes, unless the remat_gcn key says otherwise
        remat_cfg = config["remat_gcn"]
        self.remat = (self.n_users + self.n_items) > REMAT_NODES if remat_cfg is None else bool(remat_cfg)

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
        # the model axis's item split of the denoisers (``split_items``)
        self.item_cols = None

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
        carries the rec tower and both CL towers in one d = 3·latdim pass.
        With ``remat`` and autograd on, the modal passes and each layer are
        checkpointed regions (``jax.checkpoint`` in the JAX package)."""
        adj = self.norm_adj
        nu = self.n_users
        img_adj, txt_adj = state["image_ui"], state["text_ui"]
        if self.remat and torch.is_grad_enabled():
            region = lambda f, *xs: checkpoint(f, *xs, use_reentrant=False)
        else:
            region = lambda f, *xs: f(*xs)

        def modal_passes(ego, u_img, u_txt, i_embeds):
            # one pass per modal graph feeds both the main branch and its CL tower
            e_img_adj, cl1 = spmm_multi(img_adj, [ego, u_img])
            e_txt_adj, cl2 = spmm_multi(txt_adj, [ego, u_txt])
            e_img, e_txt = spmm_multi(adj, [u_img, u_txt])
            e_img_, e_txt_ = spmm_multi(
                adj, [torch.cat([e_img[:nu], i_embeds]), torch.cat([e_txt[:nu], i_embeds])]
            )
            return e_img + e_img_, e_txt + e_txt_, e_img_adj, e_txt_adj, cl1, cl2

        def layer(rec_e, cl1, cl2):
            # the rec tower's layer and both CL towers' ride one d = 3·latdim pass
            return tuple(spmm_multi(adj, [rec_e, cl1, cl2]))

        weight = torch.softmax(self.modal_weight, dim=0)
        ego = torch.cat([self.uEmbeds, self.iEmbeds])
        u_img = torch.cat([self.uEmbeds, _l2norm(self.get_image_feats())])
        u_txt = torch.cat([self.uEmbeds, _l2norm(self.get_text_feats())])
        ei, et, e_img_adj, e_txt_adj, cl1, cl2 = region(modal_passes, ego, u_img, u_txt, self.iEmbeds)
        embedsImage = ei + self.ris_adj_lambda * e_img_adj
        embedsText = et + self.ris_adj_lambda * e_txt_adj
        embedsModal = weight[0] * embedsImage + weight[1] * embedsText

        rec_e, acc = embedsModal, embedsModal
        acc1, acc2 = cl1, cl2
        for _ in range(self.gnn_layer):
            rec_e, cl1, cl2 = region(layer, rec_e, cl1, cl2)
            acc = acc + rec_e
            acc1 = acc1 + cl1
            acc2 = acc2 + cl2
        out = acc + self.ris_lambda * _l2norm(embedsModal)
        return out[:nu], out[nu:], acc1[:nu], acc1[nu:], acc2[:nu], acc2[nu:]

    def contrast_loss(self, e1, e2, nodes, weights, den=None):
        """InfoNCE of ``e1[nodes]`` against every row of ``e2``, averaged
        over ``weights`` (or divided by ``den``, a global weight sum)."""
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
        den = weights.sum() if den is None else den
        return (per * weights).sum() / den.clamp(min=1.0)

    def loss(self, state, batch, generator=None):
        """BPR over (user, pos, neg) + L2 on the full embedding tables +
        ``ssl_reg``·InfoNCE between the views that ``cl_method`` picks.
        Over a data axis (``batch["rows"]``) each term is this rank's share:
        its rows over the global weight sum, and the L2 term divided."""
        users, pos, neg, w = batch["users"], batch["pos"], batch["neg"], batch["weight"]
        rows = batch.get("rows")
        den = w.sum() if rows is None else rows.count(w.sum())
        usrEmbeds, itmEmbeds, u1, i1, u2, i2 = self._forward_joint(state)
        anc, posE, negE = usrEmbeds[users], itmEmbeds[pos], itmEmbeds[neg]
        pos_s = (anc * posE).sum(1)
        neg_s = (anc * negE).sum(1)
        bpr = -(torch.log(1e-10 + torch.sigmoid(pos_s - neg_s)) * w).sum() / den.clamp(min=1.0)
        reg = table_share(((self.uEmbeds**2).sum() + (self.iEmbeds**2).sum()) * self.reg_weight, rows)
        if self.cl_method == 1:
            cl = (
                self.contrast_loss(usrEmbeds, u1, users, w, den)
                + self.contrast_loss(itmEmbeds, i1, pos, w, den)
                + self.contrast_loss(usrEmbeds, u2, users, w, den)
                + self.contrast_loss(itmEmbeds, i2, pos, w, den)
            ) * self.ssl_reg
        else:
            cl = (self.contrast_loss(u1, u2, users, w, den) + self.contrast_loss(i1, i2, pos, w, den)) * self.ssl_reg
        total = bpr + reg + cl
        return total, (total,)

    def diffusion_losses(
        self, denoiser: Denoise, x_start, item_embeds, modal_feats, ts=None, noise=None, keep=None, generator=None
    ):
        """Per-user SNR-weighted diffusion MSE and modal-alignment loss.

        ``ts``, ``noise`` and the dropout ``keep`` mask are drawn from
        ``generator`` unless given. On the item split (``denoiser.cols``)
        ``x_start``, ``noise`` and ``keep`` hold this rank's columns (draws
        not given come together from ``diffusion_draws``): the MSE is the
        ranks' sums over their columns, summed over the model axis, over
        ``n_items``, and each product with the per-item tables takes this
        rank's rows of them, summed over the axis."""
        B = x_start.shape[0]
        dev = x_start.device
        c = denoiser.cols
        if c is not None and noise is None:
            ts, noise, keep = self.diffusion_draws(B, generator).values()
        if ts is None:
            ts = torch.randint(0, self.steps, (B,), generator=generator, device=dev)
        if noise is None:
            noise = torch.randn(x_start.shape, generator=generator, device=dev)
        x_t = q_sample(self.sched, x_start, ts, noise)
        model_output = denoiser(x_t, ts, dropout=0.5, keep=keep, generator=generator)
        if c is None:
            mse = ((x_start - model_output) ** 2).mean(dim=1)
            usr_model_embeds = model_output @ modal_feats
            usr_id_embeds = x_start @ item_embeds
        else:
            mse = c.sum(((x_start - model_output) ** 2).sum(dim=1)) / self.n_items
            usr_model_embeds = c.sum(model_output @ c.rows(modal_feats))
            usr_id_embeds = c.sum(x_start @ c.rows(item_embeds))
        weight = torch.where(ts == 0, 1.0, snr(self.sched, ts - 1) - snr(self.sched, ts))
        diff_loss = weight * mse
        gc_loss = ((usr_model_embeds - usr_id_embeds) ** 2).mean(dim=1)
        return diff_loss, gc_loss

    def full_embeddings(self, state):
        return self.forward_MM(state)

    # -- diffusion phases (driven by DiffMMTrainer) -----------------------
    def interaction_vectors(self, users: torch.Tensor) -> torch.Tensor:
        return interaction_vectors(self.data, users)

    def p_sample_users(self, denoiser: Denoise, x_start, generator=None, noise=None):
        """Reverse-diffuse interaction vectors with the eval-mode denoiser;
        ``noise`` may give the chain's draws (``sample_noise``). On the item
        split (``denoiser.cols``) every vector is this rank's columns, and
        draws not given come from ``sample_noise``."""
        if denoiser.cols is not None and noise is None:
            noise = self.sample_noise((x_start.shape[0], self.n_items), generator)
        return p_sample_loop(
            self.sched, denoiser, x_start, self.sampling_steps,
            generator=generator, sampling_noise=self.sampling_noise, noise=noise,
        )

    def sample_noise(self, shape, generator=None) -> list:
        """The draws ``p_sample_users`` makes for a batch of ``shape``, in
        its order (``sampler.chain_noise``); on the item split this rank's
        columns of them (``pm.item_planes``)."""
        noise = chain_noise(self.sched.steps, self.sampling_steps, self.sampling_noise, shape, generator, self.device)
        return pm.item_planes(noise, self.item_cols)

    def diffusion_draws(self, batch_size: int, generator=None) -> dict:
        """The draws ``diffusion_losses`` makes for a batch, in its order:
        the timesteps, the noise and the denoiser's dropout keep mask; on the
        item split this rank's columns of the planes (``pm.item_planes``)."""
        shape = (batch_size, self.n_items)
        ts = torch.randint(0, self.steps, (batch_size,), generator=generator, device=self.device)
        noise = torch.randn(shape, generator=generator, device=self.device)
        keep = torch.rand(shape, generator=generator, device=self.device) < 1.0 - 0.5
        return pm.item_planes({"ts": ts, "noise": noise, "keep": keep}, self.item_cols)

    def split_items(self, cols) -> None:
        """Put both denoisers on the model axis's item split ``cols``
        (``parallel.mesh.ItemCols``)."""
        self.denoise_image.split_items(cols)
        self.denoise_text.split_items(cols)
        self.item_cols = cols

    def rebuild_ui_graph(self, topk_items: torch.Tensor, generator=None) -> SparseGraph:
        """The regenerated modal graph of ``topk_items`` (``regenerated_ui_graph``)."""
        return regenerated_ui_graph(topk_items, self.n_users, self.n_items, self.keep_rate, generator)

    def init_state(self, generator=None) -> dict:
        """Self-loop-only graphs until the first regeneration."""
        g = placeholder_ui_graph(self.n_users, self.n_items, self.rebuild_k, self.keep_rate, self.device, generator)
        return {"image_ui": g, "text_ui": g}
