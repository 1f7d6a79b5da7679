"""GenRec-V1: binary flip diffusion for unbiased interest generation
(counterpart of ``genmmrec_tpu/models/genrecv1.py``).

- set-up: the normalized adjacency, the raw interaction matrix ``R``
  (duplicates kept as edges, which sum) and the two item-item KNN graphs of
  the image and text features (``knn_graph_sparse``, "sym");
- ``forward``: a user-item GCN over the adjacency and over the generated
  graph (``state["image_ui"]``), mixed by learned softmax weights; gated
  item-item modal towers over the KNN graphs, lifted to the users by ``R``
  (one pass at twice the width for both); an attention split of the two
  modal views into common and special parts, the special parts gated by
  the user-item embeddings;
- ``loss``: BPR, the squared norm of the embedding tables, and two pairs of
  InfoNCE terms;
- the flip-diffusion denoiser ``denoise_image`` (``ModalDenoise``) with its
  loss ``diffusion_losses`` and ``generate``, driven by
  ``GenRecV1Trainer``.

The batch norms normalize over the whole node or item set with its own
population statistics, as the JAX package's ``_bn``. The dropout masks of
the feature projections and every draw of the diffusion come from a
``torch.Generator`` unless the caller passes them in.

Parameter names follow the JAX pytree ``{"rec": {...}, "denoise_image":
{...}}`` with the ``rec`` level dropped (``genmmrec_tpu_torch.interop``).
``fusion_weight``, ``img_weight`` and ``txt_weight`` belong to that tree but
not to the forward, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from genmmrec_tpu_torch.common.init import normal, xavier_uniform
from genmmrec_tpu_torch.common.losses import row_mean, table_share
from genmmrec_tpu_torch.common.norm import Norm
from genmmrec_tpu_torch.models.base import RecModel, scalar
from genmmrec_tpu_torch.models.diffusion import flip
from genmmrec_tpu_torch.models.modal_denoise import ModalDenoise
from genmmrec_tpu_torch.ops.graph import (
    SparseGraph,
    bipartite_norm_adj,
    interaction_matrix,
    knn_graph_sparse,
    placeholder_ui_graph,
    regenerated_ui_graph,
    spmm,
    spmm_multi,
)
from genmmrec_tpu_torch.ops.topk import grouped_topk
from genmmrec_tpu_torch.parallel import mesh as pm

DROPOUT = 0.1


def _over(v, axis):
    """``v`` summed over an axis's ranks (``rows`` or ``cols``, no
    gradient), or ``v`` without one."""
    return v if axis is None else axis.count(v)


class _Block(nn.Module):
    """A linear layer and the batch norm after it."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.lin = nn.Linear(d_in, d_out)
        self.bn = Norm(d_out)

    def forward(self, x):
        return self.bn.batch_norm(self.lin(x))


def _drop(x, keep):
    return x if keep is None else torch.where(keep, x / (1.0 - DROPOUT), torch.zeros_like(x))


class GenRecV1(RecModel):
    def __init__(self, config, data):
        super().__init__(config, data)
        self.latdim = scalar(config["embedding_size"], int)
        self.n_layers = scalar(config["n_layers"], int)
        self.keep_rate = scalar(config["keep_rate"])
        self.sparse_temp = scalar(config["sparse_temp"])
        self.temp = scalar(config["temperature"])
        self.ssl_reg1 = scalar(config["ssl_reg1"])
        self.ssl_reg2 = scalar(config["ssl_reg2"])
        self.gen_topk = scalar(config["gen_topk"], int)
        self.rebuild_k = scalar(config["rebuild_k"], int)
        self.d_emb_size = scalar(config["d_emb_size"], int)
        self.num_layers = scalar(config["num_layers"], int)
        self.steps = scalar(config["steps"], int)
        self.flip_temp = scalar(config["flip_temp"])
        self.bayesian = bool(config["bayesian_samplinge_schedule"])
        self.sampling_steps = scalar(config["sampling_steps"] or 0, int)
        self.reg_weight = scalar(config["reg_weight"])
        self.knn_k = scalar(config["knn_k"], int)

        users, items = data.users.cpu().numpy(), data.items.cpu().numpy()
        self.norm_adj = bipartite_norm_adj(users, items, self.n_users, self.n_items, self.device)
        self.R = interaction_matrix(users, items, self.n_users, self.n_items, self.device)
        self.image_II = knn_graph_sparse(self.v_feat, self.knn_k, "sym")
        self.text_II = knn_graph_sparse(self.t_feat, self.knn_k, "sym")

        d = self.latdim
        self.user_embedding = nn.Parameter(torch.empty(self.n_users, d))
        self.item_id_embedding = nn.Parameter(torch.empty(self.n_items, d))
        self.origin_weight = nn.Parameter(torch.ones(1))
        self.generation_weight = nn.Parameter(torch.ones(1))
        self.img_weight = nn.Parameter(torch.ones(1))
        self.txt_weight = nn.Parameter(torch.ones(1))
        self.fusion_weight = nn.Parameter(torch.ones(3))
        self.res_scale = nn.Parameter(torch.ones(1))
        self.image_residual = _Block(self.v_feat.shape[1], d)
        self.image_modal = _Block(d, d)
        self.text_residual = _Block(self.t_feat.shape[1], d)
        self.text_modal = _Block(d, d)
        self.common1 = nn.Linear(d, d)
        self.common_bn = Norm(d)
        self.common2 = nn.Linear(d, 1, bias=False)
        self.gate_image = _Block(d, d)
        self.gate_text = _Block(d, d)
        self.denoise_image = ModalDenoise(self.n_items, self.n_items, self.d_emb_size, self.num_layers)
        # the model axis's item split of the denoiser (``split_items``)
        self.item_cols = None
        self.to(self.device)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """The JAX package's init, drawn from ``generator``: xavier-uniform
        embeddings and linear weights, zero linear biases, unit norms, unit
        mixing weights, ``img_weight``/``txt_weight`` ~ 1 + 0.1·N(0, 1), and
        the denoiser's own init."""
        for p in (self.user_embedding, self.item_id_embedding):
            p.copy_(xavier_uniform(p.shape, generator))
        for p in (self.origin_weight, self.generation_weight, self.fusion_weight, self.res_scale):
            p.fill_(1.0)
        for p in (self.img_weight, self.txt_weight):
            p.copy_(1.0 + normal(p.shape, 0.1, generator))
        for name, m in self.named_modules():
            if name.startswith("denoise_image"):
                continue
            if isinstance(m, nn.Linear):
                m.weight.copy_(xavier_uniform(m.weight.shape, generator))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, Norm):
                m.g.fill_(1.0)
                m.bias.zero_()
        self.denoise_image.init_params(generator)

    def param_groups(self) -> dict:
        """``rec`` for the main optimizer; ``denoise_image`` for phase 1's Adam
        (the JAX package's ``param_labels``, where the main optimizer sets the
        denoiser's updates to zero)."""
        dn = list(self.denoise_image.parameters())
        taken = {id(p) for p in dn}
        return {"rec": [p for p in self.parameters() if id(p) not in taken], "denoise_image": dn}

    # ------------------------------------------------------------------
    def dropout_masks(self, generator: torch.Generator) -> dict:
        """Keep masks ((n_items, latdim) bool, keep probability 0.9) of the
        two dropouts of each modality's projection, image then text."""
        draw = lambda: torch.rand(self.n_items, self.latdim, generator=generator, device=self.device) < 1.0 - DROPOUT
        return {m: (draw(), draw()) for m in ("image", "text")}

    def _project(self, residual: _Block, modal: _Block, feats, keep=None):
        k1, k2 = keep if keep is not None else (None, None)
        x = _drop(F.leaky_relu(residual(feats), 0.2), k1)
        y = _drop(F.leaky_relu(modal(x), 0.2), k2)
        return self.res_scale * x + y

    def get_image_feats(self, keep=None):
        return self._project(self.image_residual, self.image_modal, self.v_feat, keep)

    def get_text_feats(self, keep=None):
        return self._project(self.text_residual, self.text_modal, self.t_feat, keep)

    def _common(self, x):
        return self.common2(torch.tanh(self.common_bn.batch_norm(self.common1(x))))

    def _ui_gcn(self, adj: SparseGraph):
        x = torch.cat([self.user_embedding, self.item_id_embedding])
        acc = x
        for _ in range(self.n_layers):
            x = spmm(adj, x)
            acc = acc + x
        return acc / (self.n_layers + 1)

    def forward(self, state, masks: Optional[dict] = None):
        """(content, side), each (n_users + n_items, latdim). ``masks`` are
        the dropout keep masks (``dropout_masks``); None runs no dropout."""
        masks = masks or {}
        c1 = self._ui_gcn(self.norm_adj)
        c2 = self._ui_gcn(state["image_ui"])
        w = torch.softmax(torch.cat([self.origin_weight, self.generation_weight]), dim=0)
        content = w[0] * c1 + w[1] * c2

        img_feat = self.get_image_feats(masks.get("image"))
        txt_feat = self.get_text_feats(masks.get("text"))
        img_item = self.item_id_embedding * torch.sigmoid(self.gate_image(img_feat))
        txt_item = self.item_id_embedding * torch.sigmoid(self.gate_text(txt_feat))
        for _ in range(self.n_layers):
            img_item = spmm(self.image_II, img_item)
        for _ in range(self.n_layers):
            txt_item = spmm(self.text_II, txt_item)
        # the two lifts share R: one pass at twice the width
        img_user, txt_user = spmm_multi(self.R, [img_item, txt_item])
        img_ui = torch.cat([img_user, img_item])
        txt_ui = torch.cat([txt_user, txt_item])

        wc = torch.softmax(torch.cat([self._common(img_ui), self._common(txt_ui)], dim=-1), dim=-1)
        common = wc[:, 0:1] * img_ui + wc[:, 1:2] * txt_ui
        special_img = torch.sigmoid(self.gate_image(content)) * (img_ui - common)
        special_txt = torch.sigmoid(self.gate_text(content)) * (txt_ui - common)
        return content, (special_img + special_txt + common) / 4.0

    # ------------------------------------------------------------------
    def _infonce(self, v1, v2, weights, rows=None, den=None):
        """InfoNCE of each row of ``v1`` against the batch's rows of ``v2``
        (in-batch negatives: over a data axis, every rank's rows)."""
        n1 = F.normalize(v1, dim=1, eps=1e-12)
        n2 = F.normalize(v2, dim=1, eps=1e-12)
        pos = torch.exp((n1 * n2).sum(-1) / self.temp)
        neg = torch.exp(n1 @ (n2 if rows is None else rows.gather(n2)).T / self.temp).sum(1)
        per = -torch.log(pos / neg)
        den = weights.sum() if den is None else den
        return (per * weights).sum() / den.clamp(min=1.0)

    def loss(self, state, batch, generator=None, masks: Optional[dict] = None):
        """BPR + ``reg_weight``·(‖users‖² + ‖items‖²) + ``ssl_reg1``·(side vs
        content InfoNCE of items and users) + ``ssl_reg2``·(user vs item
        InfoNCE of content and side). The dropout masks are ``masks``, else
        drawn from ``generator``; with neither there is no dropout. Over a
        data axis (``batch["rows"]``) each term is this rank's share."""
        users, pos, neg, w = batch["users"], batch["pos"], batch["neg"], batch["weight"]
        rows = batch.get("rows")
        den = w.sum() if rows is None else rows.count(w.sum())
        if masks is None and generator is not None:
            masks = self.dropout_masks(generator)
        content, side = self.forward(state, masks)
        nu = self.n_users
        usr, itm = content[:nu], content[nu:]
        anc, posE, negE = usr[users], itm[pos], itm[neg]
        bpr = -(F.logsigmoid((anc * posE).sum(-1) - (anc * negE).sum(-1)) * w).sum() / den.clamp(min=1.0)
        reg = table_share(((self.user_embedding**2).sum() + (self.item_id_embedding**2).sum()) * self.reg_weight, rows)
        side_u, side_i = side[:nu], side[nu:]
        nce = lambda a, b: self._infonce(a, b, w, rows, den)
        cl1 = nce(side_i[pos], itm[pos]) + nce(side_u[users], usr[users])
        cl2 = nce(usr[users], itm[pos]) + nce(usr[users], side_i[pos])
        total = bpr + reg + cl1 * self.ssl_reg1 + cl2 * self.ssl_reg2
        return total, (total,)

    def full_embeddings(self, state):
        content, _ = self.forward(state)
        return content[: self.n_users], content[self.n_users :]

    def scores(self, state, users):
        u, i = self.full_embeddings(state)
        return u[users] @ i.T

    # -- the diffusion phases (driven by GenRecV1Trainer) ------------------
    def diffusion_draws(self, batch_size: int, generator=None) -> dict:
        """The draws ``diffusion_losses`` makes for a batch, in its order; on
        the item split this rank's columns of the planes
        (``pm.item_planes``)."""
        shape, dev = (batch_size, self.n_items), self.device
        ts = torch.randint(0, self.steps, (batch_size,), generator=generator, device=dev)
        q_noise = torch.rand(shape, generator=generator, device=dev)
        q_flip = torch.rand(shape, generator=generator, device=dev)
        draws = {"ts": ts, "q_noise": q_noise, "q_flip": q_flip,
                 **flip.p_sample_draws(shape, self.steps, self.steps, generator, dev)}
        return pm.item_planes(draws, self.item_cols)

    def generate_draws(self, batch_size: int, generator=None) -> dict:
        """The draws ``generate`` makes for a batch, in its order; on the
        item split this rank's columns of them."""
        shape = (batch_size, self.n_items)
        draws = flip.p_sample_draws(shape, self.steps, self.sampling_steps, generator, self.device)
        return pm.item_planes(draws, self.item_cols)

    def diffusion_losses(
        self, x_start, item_embeds, img_feats, txt_feats, generator=None, draws: Optional[dict] = None, rows=None
    ):
        """Phase 1's loss of a (B, n_items) batch: the pos-weighted BCE of the
        denoiser's logits at a flipped ``x_t``, the curriculum-weighted KL to
        the true flip posterior (no gradient), and 0.01 × the InfoNCE between
        the batch's interactions and the denoiser's samples, both lifted by
        ``item_embeds · img_feats`` (no gradient, as the reference's is
        zero). ``pos_weight`` and the means run over all B rows, padding
        included, as in the JAX package. ``txt_feats`` is not read, as in
        the reference's default branch.

        ``draws`` may give the timesteps ``ts`` (B,), ``q_sample``'s
        ``q_noise`` and ``q_flip``, and the contrastive chain's ``gen_init``
        (noise, flip) and ``gen_steps`` (one uniform plane per reverse step),
        in place of draws from ``generator``.

        Over a data axis (``rows``) ``x_start`` and ``draws`` hold this
        rank's rows, and the loss is its share: the sparsity, ``pos_weight``
        and the means are the global batch's, and the InfoNCE (no gradient)
        takes every rank's rows.

        On the item split (``item_cols``) ``x_start`` and the planes of
        ``draws`` hold this rank's columns (draws not given come from
        ``diffusion_draws``): the sums over the items add the ranks' partial
        sums over the model axis, and the products with the per-item tables
        take this rank's rows of them."""
        B, dev = x_start.shape[0], x_start.device
        c = self.item_cols
        if c is not None and not draws:
            draws = self.diffusion_draws(B, generator)
        draws = draws or {}
        ts = draws.get("ts")
        if ts is None:
            ts = torch.randint(0, self.steps, (B,), generator=generator, device=dev)
        sparsity = None
        if rows is None and c is None:
            pos_weight = (1.0 - x_start).sum() / (x_start.sum() + 1e-8)
        else:
            total = lambda v: _over(_over(v, c), rows)
            n = (B if rows is None else rows.n) * self.n_items
            sparsity = total((x_start == 0).sum().to(torch.float32)) / n
            pos_weight = total((1.0 - x_start).sum()) / (total(x_start.sum()) + 1e-8)
        x_t = flip.q_sample(
            x_start, ts, self.steps, self.flip_temp, generator, draws.get("q_noise"), draws.get("q_flip"), sparsity
        )
        logits = self.denoise_image(x_t, ts)
        probs = torch.sigmoid(logits)
        bce = -(pos_weight * x_start * F.logsigmoid(logits) + (1.0 - x_start) * F.logsigmoid(-logits))
        with torch.no_grad():
            gen_output, _ = flip.p_sample(
                self.denoise_image, x_start, self.steps, self.steps, self.flip_temp, self.bayesian,
                generator, draws.get("gen_init"), draws.get("gen_steps"), sparsity,
            )
            modal_emb = item_embeds * img_feats
            if c is None:
                v1, v2 = x_start @ modal_emb, gen_output @ modal_emb
            else:
                v1, v2 = (c.sum(v @ c.rows(modal_emb)) for v in (x_start, gen_output))
            if rows is None:
                cl = flip.infonce_rows(v1, v2, self.sparse_temp)
            else:
                cl = flip.infonce_rows(rows.gather(v1), rows.gather(v2), self.sparse_temp) * rows.share
        kl = flip.kl_to_posterior(x_start, ts, probs, self.steps, sparsity=sparsity, cols=c)
        curriculum = (ts.to(torch.float32) / self.steps).clamp(0.0, 0.5)
        bce = row_mean(bce, rows) if c is None else row_mean(c.sum(bce.sum(1)) / self.n_items, rows)
        return bce + row_mean(curriculum * kl, rows) + 0.01 * cl

    @torch.no_grad()
    def generate(self, x_start, generator=None, draws: Optional[dict] = None):
        """Phase 2: reverse-sample from ``x_start`` (``sampling_steps`` flips
        first), then take the sample at each row's top-``gen_topk``
        probabilities (K3) and the original elsewhere → (blended, probs).
        ``draws`` may give ``gen_init`` and ``gen_steps``. On the item split
        (``item_cols``) every plane is this rank's columns (draws not given
        come from ``generate_draws``), the flip schedules take the chunk's
        sparsity over every rank's columns, and the top-``gen_topk`` is K3
        on each rank's columns, merged."""
        c = self.item_cols
        sparsity = None
        if c is not None:
            draws = draws or self.generate_draws(x_start.shape[0], generator)
            sparsity = c.count((x_start == 0).sum().to(torch.float32)) / (x_start.shape[0] * self.n_items)
        draws = draws or {}
        denoised, probs = flip.p_sample(
            self.denoise_image, x_start, self.steps, self.sampling_steps, self.flip_temp, self.bayesian,
            generator, draws.get("gen_init"), draws.get("gen_steps"), sparsity,
        )
        k = min(self.gen_topk, self.n_items)
        if c is None:
            _, idx = grouped_topk(probs, k)
            chosen = torch.zeros_like(probs, dtype=torch.bool).scatter_(1, idx, True)
        else:
            chosen = c.holds(c.topk(probs, k)[1])
        return torch.where(chosen, denoised, x_start), probs

    def split_items(self, cols) -> None:
        """Put the denoiser on the model axis's item split ``cols``
        (``parallel.mesh.ItemCols``)."""
        self.denoise_image.split_items(cols)
        self.item_cols = cols

    def rebuild_ui_graph(self, topk_items: torch.Tensor, generator=None, keep=None) -> SparseGraph:
        """The generated user-item graph of ``topk_items`` (``regenerated_ui_graph``)."""
        return regenerated_ui_graph(topk_items, self.n_users, self.n_items, self.keep_rate, generator, keep)

    def init_state(self, generator=None) -> dict:
        """A self-loop-only generated graph until the first regeneration."""
        return {
            "image_ui": placeholder_ui_graph(
                self.n_users, self.n_items, self.rebuild_k, self.keep_rate, self.device, generator
            )
        }
