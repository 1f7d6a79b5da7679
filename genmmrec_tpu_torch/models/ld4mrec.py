"""LD4MRec: few-step conditional diffusion over interaction vectors
(counterpart of ``genmmrec_tpu/models/ld4mrec.py``).

- Condition: each user's SVD embedding (scipy ``svds`` of R on the host,
  ``u·√s``, each column's sign fixed so its largest entry is positive; a
  seeded normal table if ``svds`` fails) beside the projection of the
  one-hop D_u^-½ R D_i^-½ aggregation of the items' (vision, text)
  features, also built on the host;
- CNet: the noisy vector's hidden projection through FiLM-modulated
  residual blocks (layer norm, scale and shift from the condition plus the
  time embedding, tanh-approximated GELU, dropout), projected back to the
  items;
- its own time embedding, [sin, cos] over frequencies ``exp(-ln(1e4)·i /
  (half - 1))``, not the denoiser MLP's [cos, sin] over ``half``;
- its own schedule: 1 − ᾱ linear in t from ``min_noise_level``, the betas
  clipped to [1e-4, 0.9999];
- training: the label-smoothed x0 target, timesteps drawn in proportion to
  the EMA loss history in ``state``, which each batch updates; a timestep
  that several rows of a batch share keeps the last row's update
  (``importance.scatter_last``);
- inference: one step at the learnable ``t_in``.

The loss's draws (timesteps ``t``, ``noise``, the dropout masks ``keep``,
one a block) can be passed to ``loss``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from genmmrec_tpu_torch.common.init import xavier_normal
from genmmrec_tpu_torch.common.losses import weighted_mean
from genmmrec_tpu_torch.common.norm import Norm
from genmmrec_tpu_torch.data.arrays import interaction_vectors
from genmmrec_tpu_torch.models.base import RecModel, scalar
from genmmrec_tpu_torch.models.diffusion.importance import scatter_last
from genmmrec_tpu_torch.ops.graph import unique_ui_pairs


def ld4_time_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device) * (-math.log(10000.0) / (half - 1)))
    args = t[:, None].to(torch.float32) * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def svd_user_embedding(R, svd_k: int) -> np.ndarray:
    """(n_users, svd_k) float32 ``u·√s`` of R's top singular triplets, in
    descending order, each column's sign set so its largest-magnitude
    entry is positive, zero-padded past ``min(R.shape) - 1`` columns; a
    normal table from a generator seeded 0 when ``svds`` fails."""
    from scipy.sparse.linalg import svds

    k = min(svd_k, min(R.shape) - 1)
    try:
        u, s, _ = svds(R.tocsc(), k=k)
        u, s = u[:, ::-1], s[::-1]
        flip = np.sign(u[np.abs(u).argmax(axis=0), np.arange(u.shape[1])])
        u = u * np.where(flip == 0, 1.0, flip)[None, :]
        emb = (u * np.sqrt(s)).astype(np.float32)
        if k < svd_k:
            emb = np.pad(emb, ((0, 0), (0, svd_k - k)))
    except Exception:
        emb = np.random.default_rng(0).normal(size=(R.shape[0], svd_k)).astype(np.float32)
    return emb


class FiLMBlock(nn.Module):
    def __init__(self, h: int, device=None):
        super().__init__()
        self.ln = Norm(h).to(device)
        self.l1 = nn.Linear(h, h, device=device)
        self.l2 = nn.Linear(h, h, device=device)
        self.scale = nn.Linear(h, h, device=device)
        self.shift = nn.Linear(h, h, device=device)


class LD4MRec(RecModel):
    def __init__(self, config, data):
        super().__init__(config, data)
        from scipy.sparse import coo_matrix

        self.embedding_size = scalar(config["embedding_size"], int)
        self.steps = scalar(config["steps"], int)
        self.svd_k = scalar(config["svd_k"], int)
        self.smoothing_gamma = scalar(config["smoothing_gamma"])
        self.cnet_hidden = h = scalar(config["cnet_hidden_size"], int)
        self.dropout = scalar(config["dropout"])
        dev = self.device

        users, items = unique_ui_pairs(data.users.cpu().numpy(), data.items.cpu().numpy())
        R = coo_matrix((np.ones(len(users), np.float32), (users, items)), shape=(self.n_users, self.n_items))
        self.user_svd_emb = torch.as_tensor(svd_user_embedding(R, self.svd_k), device=dev)
        # (vision, text), not the (text, vision) of item_raw_features
        feats = np.concatenate(
            [f.cpu().numpy().astype(np.float32) for f in (self.v_feat, self.t_feat) if f is not None], axis=1
        )
        Rd = R.tocsr()
        du = np.asarray(Rd.sum(1)).ravel()
        di = np.asarray(Rd.sum(0)).ravel()
        with np.errstate(divide="ignore"):
            du = np.where(du > 0, du**-0.5, 0.0)
            di = np.where(di > 0, di**-0.5, 0.0)
        user_mm = (Rd.multiply(du[:, None]).multiply(di[None, :])) @ feats
        self.user_mm_emb = torch.as_tensor(np.asarray(user_mm, np.float32), device=dev)

        t = np.arange(1, self.steps + 1, dtype=np.float64)
        min_noise = scalar(config["min_noise_level"], default=0.001)
        one_minus = min_noise + (t - 1) / (self.steps - 1) * (1 - min_noise)
        alpha_bar = 1 - one_minus
        ab_prev = np.concatenate([[1.0], alpha_bar[:-1]])
        betas = np.clip(1 - alpha_bar / ab_prev, 0.0001, 0.9999)
        self.alpha_bar = torch.as_tensor(np.cumprod(1 - betas).astype(np.float32), device=dev)

        self.mm_project = nn.Linear(feats.shape[1], self.embedding_size, device=dev)
        self.item_proj = nn.Linear(self.n_items, h, device=dev)
        self.cond_proj = nn.Linear(self.svd_k + self.embedding_size, h, device=dev)
        self.time_proj = nn.Linear(h, h, device=dev)
        self.output_proj = nn.Linear(h, self.n_items, device=dev)
        self.t_in = nn.Parameter(torch.zeros(1, device=dev))
        self.layers = nn.ModuleList(FiLMBlock(h, dev) for _ in range(scalar(config["cnet_n_layers"], int)))

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """xavier-normal weights and zero biases; unit layer-norm scales, t_in 0."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                m.weight.copy_(xavier_normal(m.weight.shape, generator))
                m.bias.zero_()
            elif isinstance(m, Norm):
                m.g.fill_(1.0)
                m.bias.zero_()
        self.t_in.zero_()

    def init_state(self, generator=None) -> dict:
        return {"loss_history": torch.ones(self.steps, device=self.device)}

    def draws(self, generator, state, batch_size: int):
        """The loss's timesteps (in proportion to the loss history), noise
        and one dropout mask a block."""
        probs = state["loss_history"].abs()
        t = torch.multinomial(probs / probs.sum(), batch_size, replacement=True, generator=generator)
        noise = torch.randn(batch_size, self.n_items, generator=generator, device=self.device)
        keep = [
            torch.rand(batch_size, self.cnet_hidden, generator=generator, device=self.device) < 1.0 - self.dropout
            for _ in self.layers
        ]
        return t, noise, keep

    def cnet(self, x_t, t_emb, condition, keep: Optional[Sequence[torch.Tensor]] = None):
        h = self.item_proj(x_t)
        gcond = self.cond_proj(condition) + self.time_proj(t_emb)
        for i, blk in enumerate(self.layers):
            z = blk.ln.layer_norm(h)
            z = z * (1.0 + blk.scale(gcond)) + blk.shift(gcond)
            z = F.gelu(blk.l1(z), approximate="tanh")
            if keep is not None and self.dropout > 0:
                z = torch.where(keep[i], z / (1.0 - self.dropout), torch.zeros_like(z))
            h = h + blk.l2(z)
        return self.output_proj(h)

    def _condition(self, users):
        return torch.cat([self.user_svd_emb[users], self.mm_project(self.user_mm_emb[users])], dim=1)

    def loss_and_update(self, state, batch, generator=None, t=None, noise=None, keep=None):
        """The loss and the EMA history with the batch recorded. ``t`` (B,),
        ``noise`` (B, n_items) and ``keep`` (a (B, hidden) bool mask a
        block) replace the draws. Over a data axis (``batch["rows"]``) the
        draws (given or made) are the global batch's and this rank takes
        its rows; the history records every rank's rows in the global
        batch's order, so every rank holds the same history."""
        users, w = batch["users"], batch["weight"]
        rows = batch.get("rows")
        if t is None:
            t, noise, keep = self.draws(generator, state, users.shape[0] if rows is None else rows.n)
        if rows is not None:
            t, noise, keep = rows.local((t, noise, keep))
        x_in = interaction_vectors(self.data, users)
        gamma = self.smoothing_gamma
        x0_target = x_in * (1 - gamma) + (1 - x_in) * gamma
        ab = self.alpha_bar[t][:, None]
        x_t = torch.sqrt(ab) * x_in + torch.sqrt(1 - ab) * noise
        pred_x0 = self.cnet(x_t, ld4_time_embedding(t, self.cnet_hidden), self._condition(users), keep)
        per = ((pred_x0 - x0_target) ** 2).mean(dim=1)

        hist = state["loss_history"]
        upd = 0.9 * hist[t] + 0.1 * per.detach()
        # a padding row writes one spare entry past the history, cut off after
        index = torch.where(w > 0, t, self.steps)
        if rows is not None:
            index, upd = rows.gather(index), rows.gather(upd)
        new_hist = scatter_last(torch.cat([hist, hist.new_zeros(1)]), index, upd)[:-1]
        total = weighted_mean(per, w, rows)
        return total, ((total,), {"loss_history": new_hist})

    def loss(self, state, batch, generator=None, t=None, noise=None, keep=None):
        total, (parts, _) = self.loss_and_update(state, batch, generator, t, noise, keep)
        return total, parts

    def scores(self, state, users) -> torch.Tensor:
        x_in = interaction_vectors(self.data, users)
        t_val = self.t_in.abs().repeat(users.shape[0])
        return self.cnet(x_in, ld4_time_embedding(t_val, self.cnet_hidden), self._condition(users))
