"""DDRM: denoising diffusion over user and item embeddings (counterpart of
``genmmrec_tpu/models/ddrm.py``).

- LightGCN over its own row-sum normalized adjacency (``rowsum_norm_adj``:
  degrees of the unique pairs, a zero degree giving 0, not LightGCN's
  ``+1e-7``), normal(0, 0.1) tables;
- two conditional denoisers (``CondDenoise``) over the embeddings, input
  ``[noisy ; time embedding ; condition]``: the user's conditioned on its
  positive item, the item's on the user;
- loss: element-wise softplus BPR plus the scalar L2 term, mixed with the
  two reconstruction MSEs by ``alpha``, each row weighted by the detached
  ``σ(pos)^β``; its draws (timesteps, the two noises) can be passed in;
- scores: the mean of each user's history item embeddings, noised to the
  last step, then ``sampling_steps`` reverse steps of the item denoiser
  conditioned on the user, against every item. The noise of each chunk of
  users is drawn from a generator seeded 0 (the JAX package's fixed key,
  with torch's numbers), unless passed in.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from genmmrec_tpu_torch.common.init import normal
from genmmrec_tpu_torch.common.losses import weighted_mean
from genmmrec_tpu_torch.models.base import RecModel, scalar
from genmmrec_tpu_torch.models.diffusion.dnn import timestep_embedding
from genmmrec_tpu_torch.models.diffusion.schedule import make_schedule, q_posterior_mean, q_sample
from genmmrec_tpu_torch.ops.graph import _from_host, layer_mean, unique_ui_pairs

ACTS = {"tanh": torch.tanh, "sigmoid": torch.sigmoid, "relu": torch.relu}


def rowsum_norm_adj(users: np.ndarray, items: np.ndarray, n_users: int, n_items: int, device):
    """The symmetric D^-½ A D^-½ of the unique pairs, degrees the pair
    counts and a zero degree's factor 0, stably row-sorted."""
    users, items = unique_ui_pairs(users, items)
    N = n_users + n_items
    rows = np.concatenate([users, items + n_users]).astype(np.int64)
    cols = np.concatenate([items + n_users, users]).astype(np.int64)
    deg = np.bincount(rows, minlength=N).astype(np.float64)
    with np.errstate(divide="ignore"):
        dis = np.power(deg, -0.5)
    dis[np.isinf(dis)] = 0.0
    vals = (dis[rows] * dis[cols]).astype(np.float32)
    return _from_host(rows, cols, vals, N, N, device, symmetric=True)


class CondDenoise(nn.Module):
    """The conditional denoiser MLP: ``[x ; emb ; cond]`` through tanh (or
    ``act``) towers, the time embedding through ``emb_layer`` first."""

    def __init__(self, dims, latent_dim: int, act: str = "tanh", norm: bool = False, device=None):
        super().__init__()
        out_dims = list(dims) + [latent_dim]
        in_dims = out_dims[::-1]
        in_dims_temp = [in_dims[0] * 2 + latent_dim] + list(in_dims[1:])
        self.act, self.norm = ACTS[act], norm
        self.emb_layer = nn.Linear(latent_dim, latent_dim, device=device)
        self.in_layers = nn.ModuleList(
            nn.Linear(a, b, device=device) for a, b in zip(in_dims_temp[:-1], in_dims_temp[1:])
        )
        self.out_layers = nn.ModuleList(nn.Linear(a, b, device=device) for a, b in zip(out_dims[:-1], out_dims[1:]))

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """normal(0, √(2/(fan_in+fan_out))) weights, normal(0, 1e-3) biases."""
        for layer in [self.emb_layer, *self.in_layers, *self.out_layers]:
            d_out, d_in = layer.weight.shape
            layer.weight.copy_(normal((d_out, d_in), math.sqrt(2.0 / (d_in + d_out)), generator))
            layer.bias.copy_(normal((d_out,), 0.001, generator))

    def forward(self, noise_emb, con_emb, t):
        emb = self.emb_layer(timestep_embedding(t, self.emb_layer.in_features))
        if self.norm:
            noise_emb = F.normalize(noise_emb, dim=-1, eps=1e-12)
        h = torch.cat([noise_emb, emb, con_emb], dim=-1)
        for layer in self.in_layers:
            h = self.act(layer(h))
        for i, layer in enumerate(self.out_layers):
            h = layer(h)
            if i != len(self.out_layers) - 1:
                h = self.act(h)
        return h


class DDRM(RecModel):
    is_multimodal = False

    def __init__(self, config, data):
        super().__init__(config, data)
        self.latent_dim = scalar(config["embedding_size"], int)
        self.n_layers = scalar(config["lightGCN_n_layers"], int)
        self.steps = scalar(config["steps"], int)
        self.reg_weight = scalar(config["reg_weight"])
        self.alpha = scalar(config["alpha"])
        self.beta = scalar(config["beta"])
        self.sampling_steps = scalar(config["sampling_steps"] or 0, int)
        dims = config["dims"] if isinstance(config["dims"], list) else [config["dims"]]
        act, norm = str(config["act"] or "tanh"), bool(config["norm"])
        dev = self.device
        self.norm_adj = rowsum_norm_adj(
            data.users.cpu().numpy(), data.items.cpu().numpy(), self.n_users, self.n_items, dev
        )
        self.sched = make_schedule(
            str(config["noise_schedule"] or "linear-var"), scalar(config["noise_scale"]),
            scalar(config["noise_min"]), scalar(config["noise_max"]), self.steps, device=dev,
        )
        self.user_emb = nn.Parameter(torch.empty(self.n_users, self.latent_dim, device=dev))
        self.item_emb = nn.Parameter(torch.empty(self.n_items, self.latent_dim, device=dev))
        self.user_reverse = CondDenoise(dims, self.latent_dim, act, norm, dev)
        self.item_reverse = CondDenoise(dims, self.latent_dim, act, norm, dev)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        self.user_emb.copy_(normal(self.user_emb.shape, 0.1, generator))
        self.item_emb.copy_(normal(self.item_emb.shape, 0.1, generator))
        self.user_reverse.init_params(generator)
        self.item_reverse.init_params(generator)

    def encode(self):
        out = layer_mean(self.norm_adj, torch.cat([self.user_emb, self.item_emb]), self.n_layers)
        return out[: self.n_users], out[self.n_users :]

    def draws(self, generator, batch_size: int):
        """The loss's timesteps and the user and item noise."""
        t = torch.randint(0, self.steps, (batch_size,), generator=generator, device=self.device)
        shape = (batch_size, self.latent_dim)
        return t, torch.randn(shape, generator=generator, device=self.device), torch.randn(
            shape, generator=generator, device=self.device
        )

    def loss(self, state, batch, generator=None, ts=None, noise_u=None, noise_i=None):
        """``ts`` (B,) and ``noise_u``/``noise_i`` (B, latent) replace the
        draws. Over a data axis (``batch["rows"]``) the draws (given or
        made) are the global batch's and this rank takes its rows; the L2
        term that every row carries is the global batch's."""
        users, pos, neg, w = batch["users"], batch["pos"], batch["neg"], batch["weight"]
        rows = batch.get("rows")
        all_users, all_items = self.encode()
        u_e, p_e, n_e = all_users[users], all_items[pos], all_items[neg]
        B = users.shape[0] if rows is None else rows.n
        if ts is None:
            ts, noise_u, noise_i = self.draws(generator, B)
        if rows is not None:
            ts, noise_u, noise_i = rows.local((ts, noise_u, noise_i))
        out_u = self.user_reverse(q_sample(self.sched, u_e, ts, noise_u), p_e, ts)
        out_i = self.item_reverse(q_sample(self.sched, p_e, ts, noise_i), u_e, ts)
        recon = (((u_e - out_u) ** 2).mean(1) + ((p_e - out_i) ** 2).mean(1)) / 2.0
        u0, p0, n0 = self.user_emb[users], self.item_emb[pos], self.item_emb[neg]
        sq = (u0**2).sum() + (p0**2).sum() + (n0**2).sum()
        reg = 0.5 * (sq if rows is None else rows.sum(sq)) / B
        pos_s, neg_s = (u_e * p_e).sum(1), (u_e * n_e).sum(1)
        weight = torch.sigmoid(pos_s.detach()) ** self.beta
        loss_el = (1 - self.alpha) * (F.softplus(neg_s - pos_s) + reg * self.reg_weight) + self.alpha * recon
        total = weighted_mean(loss_el * weight, w, rows)
        return total, (total,)

    def eval_artifacts(self, state):
        return self.encode()

    def scores_cached(self, state, users, artifacts, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        all_users, all_items = artifacts
        u_e = all_users[users]
        h = self.data.hist[users]
        valid = (h < self.n_items).to(torch.float32)
        gathered = all_items[h.clamp(max=self.n_items - 1)] * valid[..., None]
        mean_hist = gathered.sum(1) / valid.sum(1, keepdim=True).clamp(min=1.0)
        if noise is None:
            gen = torch.Generator(device=mean_hist.device).manual_seed(0)
            noise = torch.randn(mean_hist.shape, generator=gen, device=mean_hist.device)
        tT = torch.full((u_e.shape[0],), self.steps - 1, dtype=torch.int64, device=u_e.device)
        x_t = q_sample(self.sched, mean_hist, tT, noise)
        for i in range(self.sampling_steps - 1, -1, -1):
            t = torch.full((x_t.shape[0],), i, dtype=torch.int64, device=u_e.device)
            x_t = q_posterior_mean(self.sched, self.item_reverse(x_t, u_e, t), x_t, t)
        return x_t @ all_items.T

    def scores(self, state, users, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.scores_cached(state, users, self.eval_artifacts(state), noise)
