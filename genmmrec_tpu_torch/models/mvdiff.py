"""MVDiff: multi-view diffusion recommendation (counterpart of
``genmmrec_tpu/models/mvdiff.py``; trained by ``MVDiffTrainer``).

- Modal projections: residual Linear-BN-ReLU stacks (dim → dim/4 → dim/8
  → d, then d → d → d plus a skip), dropout 0.1 after each layer in the
  loss (the masks can be passed in); BN gates; an attention split into
  common and special parts, as GenRec-V1's.
- Feature diffusion: per modality a ``feat_denoise`` network (two encoders
  over [features ; time embedding], a fusion layer and the closed form of
  a one-token attention) learns to reconstruct the noisy modal features;
  its reverse chain, plus the original features, rebuilds the item-item
  KNN graphs (``build_ii_graph``: cosine top-``knn_k`` on K3, the
  similarity rows of the chosen neighbours kept as a dense plane, values
  D^-½ S D^-½).
- Sparsity diffusion: per modality a ``denoise`` network (Linear-BN-
  LeakyReLU down and up stacks over [interaction vector ; time embedding])
  trained on eps with a sparsity-adaptive noise scale, SNR weights, the
  modal alignment ``gc`` and an InfoNCE term; its reverse chain picks the
  items of the regenerated user-item graphs (``rebuild_ui_graph``, the
  static-nnz graph of DiffMM with its paired dropout).
- On a model axis's item split (``split_items``, ``parallel.mesh.ItemCols``)
  the sparsity denoisers take and give this rank's columns of the (B,
  n_items) vectors: the first ``down`` layer (n + emb → n/2) is a partial
  product over its item columns summed over the axis, the last ``up``
  layer (n/2 → n) and its batch norm hold their rows ``[lo, hi)`` alone,
  and the layers between, with their batch norms over hidden widths, stay
  whole on every rank.
- Forward: the content GCN over the normalized adjacency plus the two
  regenerated graphs, the gated modal item towers over each modality's
  item graph plus the fusion graph, lifted to the users by R, the
  common/special fusion; loss BPR + L2 of the two tables + two InfoNCE
  heads.

The state: ``image_ui``/``text_ui`` (row-sorted, value-symmetric),
``image_ii``/``text_ii``/``fusion_ii`` (the concatenation of two KNN edge
lists, not row-sorted: the products take their row-sorted views) and the
dense planes ``image_ii_dense``/``text_ii_dense``. Parameters follow the
JAX tree ``{"rec": {...}, "denoise_image", "denoise_text",
"feat_denoise_image", "feat_denoise_text"}`` with ``rec`` dropped.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from genmmrec_tpu_torch.common.init import normal, xavier_uniform
from genmmrec_tpu_torch.common.losses import batch_rows, global_mean, table_share, weighted_mean
from genmmrec_tpu_torch.common.norm import Norm, l2n
from genmmrec_tpu_torch.data.arrays import interaction_vectors
from genmmrec_tpu_torch.models.base import RecModel, scalar
from genmmrec_tpu_torch.models.diffusion.dnn import timestep_embedding
from genmmrec_tpu_torch.models.diffusion.schedule import make_schedule, q_posterior_mean
from genmmrec_tpu_torch.ops.graph import (
    SparseGraph,
    bipartite_norm_adj,
    interaction_matrix,
    regenerated_ui_graph,
    sorted_graph,
    spmm,
    spmm_multi,
)
from genmmrec_tpu_torch.ops.precision import full_precision_matmuls
from genmmrec_tpu_torch.ops.topk import grouped_topk
from genmmrec_tpu_torch.parallel import mesh as pm

# dropout of the modal projections and the sparsity denoisers' layers
STACK_DROPOUT = 0.1
# the sparsity denoisers' input keep rate
INPUT_KEEP = 0.9
MODALITIES = ("image", "text")


class LinBN(nn.Module):
    def __init__(self, d_in: int, d_out: int, device=None):
        super().__init__()
        self.lin = nn.Linear(d_in, d_out, device=device)
        self.bn = Norm(d_out).to(device)

    def forward(self, x, rows=None):
        return self.bn.batch_norm(self.lin(x), rows)


def apply_stack(stack, x, act, keep: Optional[Sequence[torch.Tensor]] = None, rows=None):
    """Each layer's ``act(bn(lin(x)))``, then dropout by ``keep[i]``; over
    ``rows`` the batch norms take every rank's rows."""
    for i, layer in enumerate(stack):
        x = act(layer(x, rows))
        if keep is not None:
            x = torch.where(keep[i], x / (1.0 - STACK_DROPOUT), torch.zeros_like(x))
    return x


def _lrelu(z):
    return F.leaky_relu(z, 0.01)


def state_graph(g: dict, n: int) -> SparseGraph:
    """A JAX-style ``{rows, cols, vals}`` edge list in any order as a graph
    whose products take its stably row-sorted view."""
    rows = g["rows"].to(torch.int32)
    return SparseGraph(rows=rows, cols=g["cols"].to(torch.int32), vals=g["vals"].to(torch.float32),
                       row_ptr=rows.new_zeros(0), n_rows=n, n_cols=n, sorted=False)


class MVDiff(RecModel):
    def __init__(self, config, data):
        super().__init__(config, data)
        g = lambda k, d: config[k] if config[k] is not None else d
        self.latdim = d = scalar(config["embedding_size"], int)
        self.gcn_layer_num = int(g("gcn_layer_num", 1))
        self.keep_rate = float(g("keep_rate", 0.5))
        self.reg_weight = float(g("reg_weight", 1e-5))
        self.modal_fusion = bool(g("modal_fusion", True))
        self.ssl_reg = float(g("ssl_reg", 1e-2))
        self.temp = float(g("temperature", 0.7))
        self.sparse_temp = float(g("sparse_temp", 0.2))
        self.steps = int(g("steps", 5))
        self.d_emb_size = int(g("d_emb_size", 10))
        self.norm = bool(g("norm", False))
        self.rebuild_k = int(g("rebuild_k", 10))
        self.high_order_topk = int(g("high_order_topk", 2))
        self.e_loss = float(g("e_loss", 0.1))
        self.alpha_sparity = float(g("alpha_sparity", 0.01))
        self.beta_sparity = float(g("beta_sparity", 0.01))
        self.postive_gain_degree = float(g("postive_gain_degree", 0.9))
        self.knn_k = int(g("knn_k", 5))
        dev = self.device
        users, items = data.users.cpu().numpy(), data.items.cpu().numpy()
        self.norm_adj = bipartite_norm_adj(users, items, self.n_users, self.n_items, dev)
        self.R = interaction_matrix(users, items, self.n_users, self.n_items, dev)
        self.sched = make_schedule(
            "linear-var", float(g("noise_scale", 0.1)), float(g("noise_min", 1e-4)),
            float(g("noise_max", 0.02)), self.steps, device=dev, beta_fixed_value=1e-4,
        )
        self.v_dim, self.t_dim = self.v_feat.shape[1], self.t_feat.shape[1]
        v4, v8 = max(1, self.v_dim // 4), max(1, self.v_dim // 8)
        t4, t8 = max(1, self.t_dim // 4), max(1, self.t_dim // 8)
        stack = lambda dims: nn.ModuleList(LinBN(a, b, dev) for a, b in zip(dims[:-1], dims[1:]))
        self.user_embedding = nn.Parameter(torch.empty(self.n_users, d, device=dev))
        self.item_id_embedding = nn.Parameter(torch.empty(self.n_items, d, device=dev))
        self.image_residual = stack([self.v_dim, v4, v8, d])
        self.image_modal = stack([d, d, d])
        self.text_residual = stack([self.t_dim, t4, t8, d])
        self.text_modal = stack([d, d, d])
        self.gate_image = LinBN(d, d, dev)
        self.gate_text = LinBN(d, d, dev)
        self.common1 = LinBN(d, d, dev)
        self.common2 = nn.Linear(d, 1, bias=False, device=dev)
        n = self.n_items
        i2, i4, i8 = max(1, n // 2), max(1, n // 4), max(1, n // 8)

        def modal_denoise():
            return nn.ModuleDict({
                "emb": nn.Linear(self.d_emb_size, self.d_emb_size, device=dev),
                "down": stack([n + self.d_emb_size, i2, i4, i8]),
                "up": stack([i8, i4, i2, n]),
            })

        def feat_denoiser(out_dim):
            h, e = out_dim, self.d_emb_size
            lin = lambda a, b: nn.Linear(a, b, device=dev)
            norm = lambda: Norm(h).to(dev)
            return nn.ModuleDict({
                "img_enc1": lin(self.v_dim + e, h), "img_bn1": norm(), "img_enc2": lin(h, h), "img_bn2": norm(),
                "txt_enc1": lin(self.t_dim + e, h), "txt_bn1": norm(), "txt_enc2": lin(h, h), "txt_bn2": norm(),
                "fusion": lin(2 * h, h), "att_v": lin(h, h), "att_o": lin(h, h),
            })

        self.denoise_image, self.denoise_text = modal_denoise(), modal_denoise()
        self.feat_denoise_image = feat_denoiser(self.v_dim)
        self.feat_denoise_text = feat_denoiser(self.t_dim)
        self._ii_original = None
        # the model axis's item split of the sparsity denoisers (``split_items``)
        self.item_cols = None

    def split_items(self, cols) -> None:
        """Put the two sparsity denoisers on the model axis's item split
        ``cols``: the last ``up`` layer and its batch norm hold their rows
        ``[lo, hi)`` alone (``pm.hold_item_rows``)."""
        for dn in (self.denoise_image, self.denoise_text):
            pm.hold_item_rows(dn["up"][-1].lin, cols)
            pm.hold_item_rows(dn["up"][-1].bn, cols)
        self.item_cols = cols

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """xavier-uniform tables and layers with zero biases; the two
        denoisers' ``emb`` and sparsity layers normal(0, √(2/(fan_in +
        fan_out))) with normal(0, 1e-3) biases; unit norms."""
        for p in (self.user_embedding, self.item_id_embedding):
            p.copy_(xavier_uniform(p.shape, generator))
        sparse = {id(m) for dn in (self.denoise_image, self.denoise_text) for m in dn.modules()}
        for m in self.modules():
            if isinstance(m, nn.Linear):
                if id(m) in sparse:
                    d_out, d_in = m.out_features, m.in_features
                    pm.copy_rows_(m.weight, normal((d_out, d_in), float(np.sqrt(2.0 / (d_in + d_out))), generator))
                    pm.copy_rows_(m.bias, normal((d_out,), 0.001, generator))
                else:
                    m.weight.copy_(xavier_uniform(m.weight.shape, generator))
                    if m.bias is not None:
                        m.bias.zero_()
            elif isinstance(m, Norm):
                m.g.fill_(1.0)
                m.bias.zero_()

    def param_groups(self) -> dict:
        """``rec`` for the main optimizer; the four denoisers each train in
        their own phase (the JAX package's ``param_labels``: aux)."""
        aux = {n: list(getattr(self, n).parameters())
               for n in ("denoise_image", "denoise_text", "feat_denoise_image", "feat_denoise_text")}
        taken = {id(p) for ps in aux.values() for p in ps}
        return {"rec": [p for p in self.parameters() if id(p) not in taken], **aux}

    # -- modal projections ---------------------------------------------
    def modal_feats(self, m: str, keep=None):
        """One modality's projection; ``keep`` ({"residual": [...],
        "modal": [...]}) applies the loss's dropout."""
        keep = keep or {}
        x = apply_stack(getattr(self, f"{m}_residual"), self.v_feat if m == "image" else self.t_feat, F.relu,
                        keep.get("residual"))
        return apply_stack(getattr(self, f"{m}_modal"), x, F.relu, keep.get("modal")) + x

    def _gate(self, layer, x):
        return torch.sigmoid(layer(x))

    # -- sparsity (UI) denoisers ---------------------------------------
    def modal_denoise_apply(self, dn, x, t, keep=None, rows=None):
        """``keep`` ({"input", "down": [...], "up": [...]}) applies the
        training dropout: the input at keep rate 0.9, each layer at 0.1.
        ``rows``: the batch norms over every rank's rows of a batch split
        over the data axis."""
        emb = dn["emb"](timestep_embedding(t, self.d_emb_size))
        c = self.item_cols
        if self.norm:
            x = l2n(x) if c is None else x / c.enter(torch.sqrt(c.sum((x * x).sum(-1, keepdim=True)) + 1e-12))
        if keep is not None:
            x = torch.where(keep["input"], x / INPUT_KEEP, torch.zeros_like(x))
        down = None if keep is None else keep["down"]
        up = None if keep is None else keep["up"]
        if c is None:
            h = torch.cat([x, emb], dim=-1)
            h = apply_stack(dn["down"], h, _lrelu, down, rows)
            return apply_stack(dn["up"], h, _lrelu, up, rows)
        # on this rank's item columns: the first down layer's partial product,
        # summed, then the whole layers, then the last up layer's rows
        first = dn["down"][0]
        w = first.lin.weight
        z = c.sum(x @ c.columns(w).T) + emb @ w[:, c.n :].T + first.lin.bias
        h = _lrelu(first.bn.batch_norm(z, rows))
        if keep is not None:
            h = torch.where(down[0], h / (1.0 - STACK_DROPOUT), torch.zeros_like(h))
        h = apply_stack(dn["down"][1:], h, _lrelu, None if keep is None else down[1:], rows)
        h = apply_stack(dn["up"][:-1], h, _lrelu, None if keep is None else up[:-1], rows)
        return apply_stack(dn["up"][-1:], c.enter(h), _lrelu, None if keep is None else up[-1:], rows)

    def sparsity_draws(self, generator, batch_size: int) -> dict:
        """One sparsity loss's draws: timesteps, unit noise and the dropout
        masks; on the item split this rank's columns of the planes over the
        items (the noise, the input mask and the last ``up`` layer's,
        ``pm.item_planes``)."""
        dev, n = self.device, self.n_items
        rand = lambda *shape: torch.rand(shape, generator=generator, device=dev)
        dims = [n // 2, n // 4, n // 8]
        draws = dict(
            ts=torch.randint(0, self.steps, (batch_size,), generator=generator, device=dev),
            noise=torch.randn(batch_size, n, generator=generator, device=dev),
            keep=dict(
                input=rand(batch_size, n) < INPUT_KEEP,
                down=[rand(batch_size, max(1, w)) < 1.0 - STACK_DROPOUT for w in dims],
                up=[rand(batch_size, max(1, w)) < 1.0 - STACK_DROPOUT for w in (dims[1], dims[0], n)],
            ),
        )
        return pm.item_planes(draws, self.item_cols)

    def _snr(self, t):
        acp = self.sched.alphas_cumprod[t].to(torch.float32)
        return acp / (1 - acp)

    def sparsity_losses(self, dn, x_start, item_embeds, modal_feats, draws, rows=None):
        """Per row: the SNR-weighted eps MSE, ``gc`` and the InfoNCE term.
        Over ``rows`` (this rank's rows of a batch split over the data axis)
        the sparsity and the batch norms are the global batch's, and the
        InfoNCE takes every rank's rows as negatives. On the item split
        (``item_cols``) ``x_start`` and the draws' planes hold this rank's
        columns (``sparsity_draws``): each sum over the items adds the
        ranks' partial sums, and the products with the per-item tables take
        this rank's rows of them."""
        ts = draws["ts"]
        c = self.item_cols
        if c is None:
            sparsity = global_mean(x_start, rows)
        else:
            total = c.count(x_start.sum())
            total = total if rows is None else rows.count(total)
            sparsity = total / (x_start.shape[0] * (1 if rows is None else rows.mesh.data) * self.n_items)
        coe = self.alpha_sparity * (1.0 + (1.0 - sparsity)) * torch.exp(-self.beta_sparity * ts.to(torch.float32))
        mask = torch.where(x_start == 0, 1.0, self.postive_gain_degree * x_start)
        noise = draws["noise"] * (coe[:, None] * mask)
        ab = self.sched.alphas_cumprod[ts].to(torch.float32)[:, None]
        x_t = torch.sqrt(ab) * x_start + torch.sqrt(1 - ab) * noise
        out = self.modal_denoise_apply(dn, x_t, ts, draws["keep"], rows)
        w = torch.where(ts == 0, 1.0, self._snr(ts - 1) - self._snr(ts))
        mfe = item_embeds * modal_feats
        if c is None:
            mse = ((noise - out) ** 2).mean(1)
            gc = ((out @ modal_feats - x_start @ item_embeds) ** 2).mean(1)
            v1, v2 = l2n(x_start @ mfe), l2n(out @ mfe)
        else:
            mse = c.sum(((noise - out) ** 2).sum(1)) / self.n_items
            gc = (c.sum(out @ c.rows(modal_feats) - x_start @ c.rows(item_embeds)) ** 2).mean(1)
            v1, v2 = (l2n(c.sum(v @ c.rows(mfe))) for v in (x_start, out))
        contra = -torch.log(torch.exp((v1 * v2).sum(1) / self.sparse_temp)
                            / torch.exp(v1 @ batch_rows(v2, rows).T / self.sparse_temp).sum(1))
        return w * mse, gc, contra

    @torch.no_grad()
    def sparsity_p_sample(self, dn, x):
        for i in range(self.steps - 1, -1, -1):
            t = torch.full((x.shape[0],), i, dtype=torch.int64, device=x.device)
            x = q_posterior_mean(self.sched, self.modal_denoise_apply(dn, x, t), x, t)
        return x

    # -- feature denoisers ---------------------------------------------
    def feat_denoise_apply(self, p, x_img, x_txt, t, rows=None):
        """``rows``: the batch norms over every rank's rows of a batch split
        over the data axis."""
        emb = timestep_embedding(t, self.d_emb_size)
        hi = _lrelu(p["img_bn1"].batch_norm(p["img_enc1"](torch.cat([x_img, emb], -1)), rows))
        hi = _lrelu(p["img_bn2"].batch_norm(p["img_enc2"](hi), rows)) + hi
        ht = _lrelu(p["txt_bn1"].batch_norm(p["txt_enc1"](torch.cat([x_txt, emb], -1)), rows))
        ht = _lrelu(p["txt_bn2"].batch_norm(p["txt_enc2"](ht), rows)) + ht
        fusion = p["fusion"](torch.cat([hi, ht], -1))
        # a one-token cross attention in closed form: out_proj(value_proj(x))
        return fusion + p["att_o"](p["att_v"](fusion))

    def feat_diffusion_loss(self, m: str, x_img, x_txt, ts, noise, rows=None):
        """Per row: the MSE of modality ``m``'s denoiser reconstructing its
        features from their noisy copy (the other modality clean); over
        ``rows`` its batch norms take every rank's rows."""
        target = x_img if m == "image" else x_txt
        ab = self.sched.alphas_cumprod[ts].to(torch.float32)[:, None]
        noisy = torch.sqrt(ab) * target + torch.sqrt(1 - ab) * noise
        p = getattr(self, f"feat_denoise_{m}")
        out = self.feat_denoise_apply(p, noisy if m == "image" else x_img, noisy if m == "text" else x_txt, ts, rows)
        return ((target - out) ** 2).mean(1)

    @torch.no_grad()
    def feat_p_sample(self, m: str):
        """Modality ``m``'s reverse chain over every item from its features."""
        p = getattr(self, f"feat_denoise_{m}")
        x = self.v_feat if m == "image" else self.t_feat
        for i in range(self.steps - 1, -1, -1):
            t = torch.full((x.shape[0],), i, dtype=torch.int64, device=x.device)
            out = self.feat_denoise_apply(p, x if m == "image" else self.v_feat, x if m == "text" else self.t_feat, t)
            x = q_posterior_mean(self.sched, out, x, t)
        return x

    # -- graphs ---------------------------------------------------------
    def rebuild_ui_graph(self, topk_items, generator=None, keep=None) -> SparseGraph:
        return regenerated_ui_graph(topk_items, self.n_users, self.n_items, self.keep_rate, generator, keep)

    @torch.no_grad()
    def build_ii_graph(self, feats):
        """(dense plane, edge list) of the top-``knn_k`` cosine neighbours
        (K3, ties to the lower index): the plane holds the chosen
        similarities where they stand, the edges D^-½ S D^-½ with D the
        row sums + 1e-7."""
        full_precision_matmuls()
        f = l2n(feats)
        sim = f @ f.T
        vals, idx = grouped_topk(sim, min(self.knn_k, self.n_items))
        n, k = idx.shape
        dense = torch.zeros_like(sim).scatter_(1, idx, vals)
        rows = torch.arange(n, device=f.device).repeat_interleave(k)
        cols, v = idx.reshape(-1), vals.reshape(-1)
        deg = v.view(n, k).sum(1) + 1e-7
        return dense, {"rows": rows, "cols": cols, "vals": deg[rows] ** -0.5 * v * deg[cols] ** -0.5}

    def original_ii_graphs(self):
        """The KNN edge lists of the original features, built once."""
        if self._ii_original is None:
            self._ii_original = tuple(self.build_ii_graph(f)[1] for f in (self.v_feat, self.t_feat))
        return self._ii_original

    @staticmethod
    def _cat(a: dict, b: dict) -> dict:
        return {k: torch.cat([a[k], b[k]]) for k in a}

    def ii_state(self, den_img, den_txt) -> dict:
        """The item-graph state from the denoised features: each modality's
        graph beside the original one's edges, the fusion graph of the two
        denoised ones, and the two dense planes."""
        img_dense, img = self.build_ii_graph(den_img)
        txt_dense, txt = self.build_ii_graph(den_txt)
        img_o, txt_o = self.original_ii_graphs()
        n = self.n_items
        return {
            "image_ii": state_graph(self._cat(img, img_o), n),
            "text_ii": state_graph(self._cat(txt, txt_o), n),
            "fusion_ii": state_graph(self._cat(img, txt), n),
            "image_ii_dense": img_dense,
            "text_ii_dense": txt_dense,
        }

    def state_graph_from_edges(self, name: str, edges: dict) -> SparseGraph:
        """A state graph from its edge tensors (``interop.from_jax_state``):
        the user-item graphs row-sorted and value-symmetric, the item graphs
        in their edges' order."""
        if name.endswith("_ui"):
            N = self.n_users + self.n_items
            return sorted_graph(edges["rows"], edges["cols"], edges["vals"], N, N, symmetric=True)
        return state_graph(edges, self.n_items)

    @torch.no_grad()
    def init_state(self, generator=None, keep=None) -> dict:
        """Placeholder user-item graphs (item 0 as everyone's pick, user-item
        values 0, the self loops' values kept after the paired dropout,
        whose masks ``keep`` ({"image": (m_ui, m_loop), "text": ...}) can
        give), the original KNN graphs beside empty edge lists (n·k edges
        0 → 0 of value 0), an empty fusion graph and the dense planes."""
        U, n = self.n_users, self.n_items
        keep = keep or {}

        def placeholder(k, m):
            g = self.rebuild_ui_graph(torch.zeros(U, k, dtype=torch.int64, device=self.device), generator, keep.get(m))
            return dataclasses.replace(g, vals=torch.where(g.rows == g.cols, g.vals, torch.zeros_like(g.vals)))

        nk = min(self.knn_k, n)
        empty = {"rows": torch.zeros(n * nk, dtype=torch.int64, device=self.device),
                 "cols": torch.zeros(n * nk, dtype=torch.int64, device=self.device),
                 "vals": torch.zeros(n * nk, device=self.device)}
        ii_dense, ii = self.build_ii_graph(self.v_feat)
        ti_dense, ti = self.build_ii_graph(self.t_feat)
        return {
            "image_ui": placeholder(self.rebuild_k + self.high_order_topk, "image"),
            "text_ui": placeholder(self.rebuild_k, "text"),
            "image_ii": state_graph(self._cat(ii, empty), n),
            "text_ii": state_graph(self._cat(ti, empty), n),
            "fusion_ii": state_graph(self._cat(empty, empty), n),
            "image_ii_dense": ii_dense,
            "text_ii_dense": ti_dense,
        }

    # -- forward / loss -------------------------------------------------
    def forward(self, state, keep=None):
        """(users, items, side, content); ``keep`` ({"image": {...}, "text":
        {...}}, see ``modal_feats``) applies the loss's dropout."""
        keep = keep or {}
        image_feats = self.modal_feats("image", keep.get("image"))
        text_feats = self.modal_feats("text", keep.get("text"))
        ego = torch.cat([self.user_embedding, self.item_id_embedding])
        acc, x = ego, ego
        for _ in range(self.gcn_layer_num):
            x = spmm(self.norm_adj, x) + spmm(state["image_ui"], x) + spmm(state["text_ui"], x)
            acc = acc + x
        content = acc / (self.gcn_layer_num + 1)

        img_item = self.item_id_embedding * self._gate(self.gate_image, image_feats)
        txt_item = self.item_id_embedding * self._gate(self.gate_text, text_feats)
        for _ in range(self.gcn_layer_num):
            img_item = spmm(state["image_ii"], img_item) + (
                spmm(state["fusion_ii"], img_item) if self.modal_fusion else 0.0)
            txt_item = spmm(state["text_ii"], txt_item) + (
                spmm(state["fusion_ii"], txt_item) if self.modal_fusion else 0.0)
        # the two R-lifts share R: one column-batched pass
        img_u, txt_u = spmm_multi(self.R, [img_item, txt_item])
        img_ui = torch.cat([img_u, img_item])
        txt_ui = torch.cat([txt_u, txt_item])

        com = lambda x: self.common2(torch.tanh(self.common1(x)))
        wc = torch.softmax(torch.cat([com(img_ui), com(txt_ui)], dim=-1), dim=-1)
        common = wc[:, 0:1] * img_ui + wc[:, 1:2] * txt_ui
        sp_img = (img_ui - common) * self._gate(self.gate_image, content)
        sp_txt = (txt_ui - common) * self._gate(self.gate_text, content)
        side = (sp_img + sp_txt + common) / 4.0
        all_e = content + side
        return all_e[: self.n_users], all_e[self.n_users :], side, content

    def loss_draws(self, generator) -> dict:
        """The loss's dropout masks of the four projection stacks."""
        rand = lambda layer, n: torch.rand(n, layer.lin.out_features, generator=generator, device=self.device)
        return {
            m: {part: [rand(layer, self.n_items) < 1.0 - STACK_DROPOUT for layer in getattr(self, f"{m}_{part}")]
                for part in ("residual", "modal")}
            for m in MODALITIES
        }

    @staticmethod
    def _infonce(v1, v2, temp, weights, rows=None):
        """Over ``rows`` the negatives are every rank's rows of ``v2``."""
        n1, n2 = l2n(v1), l2n(v2)
        per = -torch.log(torch.exp((n1 * n2).sum(-1) / temp) / torch.exp(n1 @ batch_rows(n2, rows).T / temp).sum(1))
        return weighted_mean(per, weights, rows)

    def loss(self, state, batch, generator=None, keep=None):
        """``keep`` (``loss_draws()``) replaces the dropout draws. Over a data
        axis (``batch["rows"]``) the draws, over whole tables, are the same
        on every rank, the L2 term is shared and the InfoNCE heads take
        every rank's rows as negatives."""
        users, pos, neg, w = batch["users"], batch["pos"], batch["neg"], batch["weight"]
        rows = batch.get("rows")
        if keep is None:
            keep = self.loss_draws(generator)
        usr, itm, side, content = self.forward(state, keep)
        anc, p_e, n_e = usr[users], itm[pos], itm[neg]
        bpr = weighted_mean(-F.logsigmoid((anc * p_e).sum(1) - (anc * n_e).sum(1)), w, rows)
        reg = table_share(((self.user_embedding**2).sum() + (self.item_id_embedding**2).sum()) * self.reg_weight, rows)
        side_u, side_i = side[: self.n_users], side[self.n_users :]
        cont_u, cont_i = content[: self.n_users], content[self.n_users :]
        nce = lambda a, b: self._infonce(a, b, self.temp, w, rows)
        cl1 = nce(side_i[pos], cont_i[pos]) + nce(side_u[users], cont_u[users])
        cl2 = nce(anc, cont_i[pos]) + nce(anc, side_i[pos])
        total = bpr + reg + (cl1 + cl2) * self.ssl_reg
        return total, (total,)

    def full_embeddings(self, state):
        usr, itm, _, _ = self.forward(state)
        return usr, itm

    @torch.no_grad()
    def high_order_items(self, state, interest) -> torch.Tensor:
        """(B, rebuild_k + high_order_topk) items of each user from its
        ``interest`` (B, rebuild_k) items: the top ``rebuild_k`` of each
        interest item's row of ``image_ii_dense ∘ text_ii_dense``, then the
        top ``rebuild_k + high_order_topk`` of those rebuild_k² products.
        The rows are mostly exact zeros, so every top-k here is K3's
        (ties to the lower index, as the JAX package's ``lax.top_k``)."""
        B, rk = interest.shape
        sim = state["image_ii_dense"][interest] * state["text_ii_dense"][interest]
        probs, idx = grouped_topk(sim.reshape(B * rk, -1), rk)
        _, sel = grouped_topk(probs.reshape(B, rk * rk), rk + self.high_order_topk)
        return idx.reshape(B, rk * rk).gather(1, sel)

    @torch.no_grad()
    def ui_topk(self, state, m: str, users) -> torch.Tensor:
        """Modality ``m``'s picks for ``users``: the top ``rebuild_k`` of the
        reverse-diffused interaction vectors (K3), expanded by
        ``high_order_items`` for the image."""
        x = interaction_vectors(self.data, users, self.item_cols)
        den = self.sparsity_p_sample(getattr(self, f"denoise_{m}"), x)
        return self.select_ui_items(state, m, den)

    def select_ui_items(self, state, m: str, den) -> torch.Tensor:
        """On the item split ``den`` is this rank's columns, and the top
        ``rebuild_k`` is K3 on each rank's columns, merged."""
        c = self.item_cols
        _, top = grouped_topk(den, self.rebuild_k) if c is None else c.topk(den, self.rebuild_k)
        return self.high_order_items(state, top) if m == "image" else top
