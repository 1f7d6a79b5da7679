"""CoDMR: collaborative diffusion models for recommendation (counterpart of
``genmmrec_tpu/models/codmr.py``).

- Target GCN over the symmetric (+I) D^-½ (A + I) D^-½ user-item graph
  (``uiMat``; ``uinorm`` its degrees), auxiliary towers over the textual
  projections (users: a table, items: the text features) on the same
  graph and over the two item-item KNN graphs (text, vision; ``sym``, K3
  on the card), each a layer mean of row-normalized layers;
- two-stage diffusion per domain (items from the two KNN towers, text
  items, text users): the unconditional denoiser (``non``, x0, input
  dropout 0.5) whose averaged reconstruction feeds the conditional one
  (``cdn``, eps), conditioned on projections of the detached target
  embeddings; over the full user and item matrices every batch;
- its own schedule: betas ``linspace(√start, √end, steps)²``;
- loss: BPR + reg, the six diffusion MSEs, the structure MSE of the
  condition aggregated over ``uiMat``, two reconstruction BPR heads and two
  InfoNCE terms. The draws (per diffusion: timesteps, noise, and the
  unconditional denoiser's dropout mask) can be passed in;
- ``eval_artifacts``: the two-stage reverse chain from each domain
  (``sampling_steps`` of noise first, drawn from a generator seeded 0 at
  each chain, the JAX package's fixed key with torch's numbers, unless
  passed in), averaged with the interest embeddings.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from genmmrec_tpu_torch.common.init import normal, xavier_normal, xavier_uniform
from genmmrec_tpu_torch.common.losses import table_share, weighted_mean
from genmmrec_tpu_torch.common.norm import Norm, l2n
from genmmrec_tpu_torch.models.base import RecModel, scalar
from genmmrec_tpu_torch.models.diffusion.dnn import timestep_embedding
from genmmrec_tpu_torch.models.diffusion.schedule import q_posterior_mean, q_sample, schedule_from_betas
from genmmrec_tpu_torch.ops.graph import _from_host, knn_graph_sparse, spmm, unique_ui_pairs

# the unconditional denoiser's input dropout
NON_DROPOUT = 0.5
# the six diffusions of the loss: (domain, denoiser), in the JAX package's key order
DIFFUSIONS = (("ii", "non"), ("ii", "cdn"), ("txi", "non"), ("txi", "cdn"), ("txu", "non"), ("txu", "cdn"))


def self_looped_ui_graph(users, items, n_users: int, n_items: int, device):
    """(graph, degrees): D^-½ (A + I) D^-½ of the unique pairs in both
    directions plus a self loop on every node, stably row-sorted."""
    users, items = unique_ui_pairs(users, items)
    N = n_users + n_items
    rows = np.concatenate([users, items + n_users, np.arange(N)]).astype(np.int64)
    cols = np.concatenate([items + n_users, users, np.arange(N)]).astype(np.int64)
    deg = np.bincount(rows, minlength=N).astype(np.float64)
    with np.errstate(divide="ignore"):
        dis = np.power(deg, -0.5)
    dis[np.isinf(dis)] = 0.0
    graph = _from_host(rows, cols, dis[rows] * dis[cols], N, N, device, symmetric=True)
    return graph, torch.as_tensor(deg.astype(np.float32), device=device)


class CoDMR(RecModel):
    def __init__(self, config, data):
        super().__init__(config, data)
        self.hide_dim = d = scalar(config["embedding_size"], int)
        self.uiLayers = scalar(config["uiLayers"], int)
        self.au_uiLayers = scalar(config["au_uiLayers"], int)
        self.reg = scalar(config["reg_weight"])
        self.ssl_temp = scalar(config["ssl_temp"])
        self.steps = scalar(config["steps"], int)
        self.sampling_steps = scalar(config["sampling_steps"], int)
        self.emb_size = e = scalar(config["emb_size"] or 10, int)
        self.knn_k = scalar(config["knn_k"] or 10, int)
        self.elbo_w = scalar(config["elbo_w"])
        self.di_pre_w = scalar(config["di_pre_w"])
        self.con_fe_w = scalar(config["con_fe_w"])
        self.ssl_reg = scalar(config["ssl_reg"])
        self.eps_mode = str(config["mean_type"] or "eps") == "eps"
        dev = self.device

        self.uiMat, self.uinorm = self_looped_ui_graph(
            data.users.cpu().numpy(), data.items.cpu().numpy(), self.n_users, self.n_items, dev
        )
        self.iciMat = knn_graph_sparse(self.t_feat, self.knn_k, "sym")
        self.icaiMat = knn_graph_sparse(self.v_feat, self.knn_k, "sym")
        self.text_dim = self.t_feat.shape[1]

        # the reference rewrites linear and linear-var to this sqrt-space form
        noise_schedule = config["noise_schedule"] or "linear"
        if noise_schedule not in ("linear", "linear-var"):
            raise ValueError(
                f"CoDMR supports only linear/linear-var noise_schedule (got {noise_schedule!r}); the reference "
                "rewrites both to the sqrt-space schedule"
            )
        start = scalar(config["noise_scale"]) * scalar(config["noise_min"])
        end = scalar(config["noise_scale"]) * scalar(config["noise_max"])
        self.sched = schedule_from_betas(np.linspace(start**0.5, end**0.5, self.steps, dtype=np.float64) ** 2, dev)

        table = lambda n, m: nn.Parameter(torch.empty(n, m, device=dev))
        self.user_emb = table(self.n_users, d)
        self.item_emb = table(self.n_items, d)
        self.uinterest_emb = table(self.n_users, d)
        self.user_emb_text = table(self.n_users, self.text_dim)
        self.item_text_net = nn.Linear(self.text_dim, d, bias=False, device=dev)
        encoder = lambda: nn.ModuleDict({"l1": nn.Linear(d, d, device=dev), "l2": nn.Linear(d, d, device=dev)})
        self.encodecon1, self.encodecon2 = encoder(), encoder()
        lin = lambda a, b: nn.Linear(a, b, device=dev)
        self.non = nn.ModuleDict({"emb_layer": lin(e, e), "in": lin(d + e, d), "ln": Norm(d).to(dev), "out": lin(d, d)})
        self.cdn = nn.ModuleDict({
            "emb_layer": lin(e, e), "in": lin(d + e, d), "ln1": Norm(d).to(dev), "ln2": Norm(d).to(dev),
            "in1": lin(d, d), "out": lin(d, 2 * d), "out1": lin(d, d),
        })

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """xavier-uniform tables, xavier-normal projections with zero biases;
        the denoisers' layers normal(0, √(2/(fan_in+fan_out))) with
        normal(0, 1e-3) biases, their norms unit."""
        for p in (self.user_emb, self.item_emb, self.uinterest_emb, self.user_emb_text):
            p.copy_(xavier_uniform(p.shape, generator))
        for layer in (self.item_text_net, *self.encodecon1.values(), *self.encodecon2.values()):
            layer.weight.copy_(xavier_normal(layer.weight.shape, generator))
            if layer.bias is not None:
                layer.bias.zero_()
        for m in (*self.non.values(), *self.cdn.values()):
            if isinstance(m, nn.Linear):
                d_out, d_in = m.weight.shape
                m.weight.copy_(normal(m.weight.shape, float(np.sqrt(2.0 / (d_in + d_out))), generator))
                m.bias.copy_(normal(m.bias.shape, 0.001, generator))
            else:
                m.g.fill_(1.0)
                m.bias.zero_()

    # -- denoisers ------------------------------------------------------
    def _non_apply(self, x, cond, t, keep=None):
        """The unconditional x0 denoiser; ``keep`` applies its input dropout."""
        p = self.non
        emb = p["emb_layer"](timestep_embedding(t, self.emb_size))
        if keep is not None:
            x = torch.where(keep, x / NON_DROPOUT, torch.zeros_like(x))
        h = torch.tanh(p["ln"].layer_norm(p["in"](torch.cat([emb, x], dim=-1))))
        return p["out"](h)

    def _cdn_apply(self, x, cond, t, keep=None):
        """The conditional denoiser (no dropout)."""
        p, d = self.cdn, self.hide_dim
        emb = p["emb_layer"](timestep_embedding(t, self.emb_size))
        h = torch.tanh(p["ln2"].layer_norm(p["in"](torch.cat([emb, cond], dim=-1))))
        h = p["out"](h)
        xt = x * h[:, :d] + h[:, d:] + x
        return p["out1"](torch.tanh(p["ln1"].layer_norm(p["in1"](xt))))

    def _pred_x0_from_eps(self, x_t, t, eps):
        acp = self.sched.alphas_cumprod[t].to(x_t.dtype)[:, None]
        return torch.sqrt(1.0 / acp) * x_t - torch.sqrt(1.0 / acp - 1.0) * eps

    def _train_diff(self, which, x_start, cond, ts, noise, keep):
        x_t = q_sample(self.sched, x_start, ts, noise)
        eps_mode = which == "cdn" and self.eps_mode
        out = (self._non_apply if which == "non" else self._cdn_apply)(x_t, cond, ts, keep)
        mse = (((noise if eps_mode else x_start) - out) ** 2).mean(1).mean()
        return mse, (self._pred_x0_from_eps(x_t, ts, out) if eps_mode else out)

    def _p_sample(self, which, x_start, cond, noise=None):
        """The reverse chain from ``x_start`` re-noised by ``sampling_steps``."""
        N = x_start.shape[0]
        eps_mode = which == "cdn" and self.eps_mode
        apply = self._non_apply if which == "non" else self._cdn_apply
        x = x_start
        if self.sampling_steps > 0:
            if noise is None:
                gen = torch.Generator(device=x.device).manual_seed(0)
                noise = torch.randn(x.shape, generator=gen, device=x.device)
            t0 = torch.full((N,), self.sampling_steps - 1, dtype=torch.int64, device=x.device)
            x = q_sample(self.sched, x_start, t0, noise)
        for i in range(self.steps - 1, -1, -1):
            t = torch.full((N,), i, dtype=torch.int64, device=x.device)
            out = apply(x, cond, t)
            x = q_posterior_mean(self.sched, self._pred_x0_from_eps(x, t, out) if eps_mode else out, x, t)
        return x

    # -- encoders -------------------------------------------------------
    def encode(self):
        def layer_means(graph, x, n_layers):
            acc = [x]
            for _ in range(n_layers):
                x = spmm(graph, x)
                acc.append(l2n(x))
            return torch.stack(acc, 1).mean(1)

        uiE = layer_means(self.uiMat, torch.cat([self.user_emb, self.item_emb]), self.uiLayers)
        tx = torch.cat([self.item_text_net(self.user_emb_text), self.item_text_net(self.t_feat)])
        txE = layer_means(self.uiMat, tx, self.au_uiLayers)
        return {
            "ui_user": uiE[: self.n_users],
            "ui_item": uiE[self.n_users :],
            "ui_full": uiE,
            "tx_user": txE[: self.n_users],
            "tx_item": txE[self.n_users :],
            "item0": layer_means(self.iciMat, self.item_emb, self.au_uiLayers),
            "item1": layer_means(self.icaiMat, self.item_emb, self.au_uiLayers),
        }

    def _conditions(self, enc):
        con = lambda p, x: p["l2"](F.relu(p["l1"](x)))
        return con(self.encodecon2, enc["ui_user"].detach()), con(self.encodecon1, enc["ui_item"].detach())

    def draws(self, generator):
        """Each of ``DIFFUSIONS``' (timesteps, noise, dropout mask or None)."""
        out = []
        for domain, which in DIFFUSIONS:
            n = self.n_users if domain == "txu" else self.n_items
            shape = (n, self.hide_dim)
            keep = (torch.rand(shape, generator=generator, device=self.device) < 1.0 - NON_DROPOUT
                    if which == "non" else None)
            out.append((torch.randint(0, self.steps, (n,), generator=generator, device=self.device),
                        torch.randn(shape, generator=generator, device=self.device), keep))
        return out

    @staticmethod
    def _bpr(u, p, n, w, rows=None):
        return weighted_mean(-F.logsigmoid((u * p).sum(1) - (u * n).sum(1)), w, rows)

    def loss(self, state, batch, generator=None, draws=None):
        """``draws`` (``draws()``'s list) replace the draws. Over a data axis
        (``batch["rows"]``) the six diffusions and the reconstruction, over
        whole tables, are the same on every rank and shared; the batch's
        terms are this rank's rows' share of the global batch's."""
        users, pos, neg, w = batch["users"], batch["pos"], batch["neg"], batch["weight"]
        rows = batch.get("rows")
        B = users.shape[0] if rows is None else rows.n
        if draws is None:
            draws = self.draws(generator)
        enc = self.encode()
        cond_u, cond_i = self._conditions(enc)

        def two_stage(start, cond, d_non, d_cdn):
            elbo_non, rec_non = self._train_diff("non", start, cond, *d_non)
            mid = (rec_non.detach() + start) / 2.0
            elbo, rec = self._train_diff("cdn", mid, cond.detach(), *d_cdn)
            return elbo_non + elbo, rec

        start_ii = ((enc["item0"] + enc["item1"]) / 2.0).detach()
        elbo_ii, rec_ii = two_stage(start_ii, cond_i, draws[0], draws[1])
        elbo_txi, rec_txi = two_stage(enc["tx_item"].detach(), cond_i, draws[2], draws[3])
        elbo_txu, rec_txu = two_stage(enc["tx_user"].detach(), cond_u, draws[4], draws[5])

        recon = spmm(self.uiMat, torch.cat([cond_u, cond_i])) / (self.uinorm[:, None] + 1e-8)
        mse = table_share(2.0 * ((recon - enc["ui_full"]) ** 2).sum(1).mean(), rows)

        sq = lambda *xs: sum((x**2).sum() for x in xs) / B
        u_e, p_e, n_e = enc["ui_user"][users], enc["ui_item"][pos], enc["ui_item"][neg]
        bpr, reg = self._bpr(u_e, p_e, n_e, w, rows), sq(u_e, p_e, n_e)
        du, dp, dn = rec_txu[users], rec_txi[pos], rec_txi[neg]
        pre_u, d1p, d1n = self.uinterest_emb[users], rec_ii[pos], rec_ii[neg]
        loss_diff = (0.95 * (self._bpr(du, dp, dn, w, rows) + sq(du, dp, dn) * self.reg)
                     + 0.95 * (self._bpr(pre_u, d1p, d1n, w, rows) + sq(pre_u, d1p, d1n) * self.reg)) / 2.0
        elbo = table_share((elbo_txi + elbo_txu) + elbo_ii, rows)

        def ssl(a, b, idx):
            na, nb = l2n(a[idx]), l2n(b[idx])
            pos_s = torch.exp((na * nb).sum(1) / self.ssl_temp)
            ttl = torch.exp(na @ l2n(b).T / self.ssl_temp).sum(1)
            return weighted_mean(-torch.log(pos_s / ttl), w, rows)

        ssloss = (ssl(rec_txi, rec_ii, pos) + ssl(rec_txu, self.uinterest_emb, users)) / 2.0
        total = (0.95 * (bpr + reg * self.reg) + elbo * self.elbo_w + loss_diff * self.di_pre_w
                 + mse * self.con_fe_w + ssloss * self.ssl_reg)
        return total, (total,)

    def eval_artifacts(self, state, noise: Optional[dict] = None):
        """``noise`` (``{"items": (n_items, d), "users": (n_users, d)}``)
        replaces the chains' re-noising draws."""
        noise = noise or {}
        enc = self.encode()
        cond_u, cond_i = self._conditions(enc)
        start_ii = (enc["item0"] + enc["item1"]) / 2.0

        def chain(start, cond, side):
            n = noise.get(side)
            r_non = self._p_sample("non", start, cond, n)
            mid = (r_non + start) / 2.0
            return 0.5 * self._p_sample("cdn", mid, cond, n) + 0.5 * mid

        reitemedii = chain(start_ii, cond_i, "items")
        reitemedtx = chain(enc["tx_item"], cond_i, "items")
        reuseredtx = chain(enc["tx_user"], cond_u, "users")
        return (self.uinterest_emb + reuseredtx) / 2.0, (reitemedtx + reitemedii) / 2.0

    def scores_cached(self, state, users, artifacts) -> torch.Tensor:
        user_emb, item_emb = artifacts
        return user_emb[users] @ item_emb.T
