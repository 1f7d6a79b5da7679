"""MCDRec: multimodal conditioned diffusion with diffusion-guided graph
denoising (counterpart of ``genmmrec_tpu/models/mcdrec.py``).

- LightGCN over the symmetric D^-½ A D^-½ adjacency of the unique pairs
  (a zero degree's factor 0), normal(0, 0.1) tables. The edge layout is
  fixed (``SampledUIGraph``: both directions, stably row-sorted; on the
  card its row pointer and list of long rows are built once); only the
  values change, so every epoch's graph runs K1 forward and, being
  value-symmetric, backward on the same edges.
- A conditional U-Net denoiser over each item embedding as a √d×√d map
  with the visual and text projections as two more channels and an
  additive time embedding: im2col products (``conv_gemm``) with the JAX
  package's OIHW weights (held in ``nn.Conv2d`` modules), batch norms over
  the current batch (no running statistics), SiLU.
- Per epoch (``pre_epoch``), diffusion-guided graph denoising: the U-Net
  reverse-diffuses every item from noise (``steps`` steps, with noise),
  ``item_emb + ω·x`` scores each pair, and ``(1 − ρ)`` of the pairs are
  kept without replacement in proportion to ``relu(1 + τ·score)`` by a
  Gumbel top-k whose threshold is the sorted score at ``n_edges − n_keep``
  (ties kept); the kept pairs are re-normalized. Its draws (the start, the
  per-step noise, the uniforms) can be passed in.
- Loss: BPR plus ``lambda_dm`` times the U-Net's x0 MSE on the positive
  items; its draws (timesteps, noise) can be passed in.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from genmmrec_tpu_torch.common.init import normal, uniform, xavier_normal
from genmmrec_tpu_torch.common.losses import weighted_mean
from genmmrec_tpu_torch.common.norm import EPS, Norm, batch_stats
from genmmrec_tpu_torch.models.base import RecModel, scalar
from genmmrec_tpu_torch.models.diffusion.dnn import timestep_embedding
from genmmrec_tpu_torch.models.diffusion.schedule import _bcast, make_schedule, q_posterior_mean, q_sample
from genmmrec_tpu_torch.ops.graph import SampledUIGraph, layer_mean

# the weight of the reverse-diffused item in the edge scores
OMEGA = 0.1


def conv_gemm(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` (stride 1, its padding) as one im2col product: the padded
    maps' shifted views stacked in (channel, row, column) order against the
    OIHW weight flattened the same way, a float32 GEMM forward and
    backward. On these 8×8 maps cuDNN's heuristics pick FFT convolutions,
    whose rounding after an epoch moved the batch norms' scale gradients
    (cancellations over 131,072 terms) on the card past the check that
    holds them to the CPU's. ``F.unfold`` is not used: on the card it
    launches one im2col a sample."""
    B, C, H, W = x.shape
    (kh, kw), (ph, pw) = conv.kernel_size, conv.padding
    xp = F.pad(x, (pw, pw, ph, ph))
    cols = torch.stack([xp[:, :, i : i + H, j : j + W] for i in range(kh) for j in range(kw)], dim=2)
    out = torch.einsum("ok,bkp->bop", conv.weight.reshape(conv.out_channels, -1), cols.reshape(B, C * kh * kw, H * W))
    return (out + conv.bias[:, None]).reshape(B, conv.out_channels, H, W)


def bn2d(x: torch.Tensor, norm: Norm, rows=None) -> torch.Tensor:
    """Batch norm of (B, C, H, W) maps over (B, H, W), population variance;
    over ``rows`` the statistics of every rank's maps."""
    mu, var = batch_stats(x, (0, 2, 3), rows)
    return (x - mu) / torch.sqrt(var + EPS) * norm.g[None, :, None, None] + norm.bias[None, :, None, None]


class ConvBlock(nn.Module):
    def __init__(self, in_c: int, out_c: int, device=None):
        super().__init__()
        self.c1 = nn.Conv2d(in_c, out_c, 3, padding=1, device=device)
        self.bn1 = Norm(out_c).to(device)
        self.c2 = nn.Conv2d(out_c, out_c, 3, padding=1, device=device)
        self.bn2 = Norm(out_c).to(device)

    def forward(self, x, rows=None):
        x = F.silu(bn2d(conv_gemm(self.c1, x), self.bn1, rows))
        return F.silu(bn2d(conv_gemm(self.c2, x), self.bn2, rows))


class UNet(nn.Module):
    def __init__(self, latent_dim: int, device=None):
        super().__init__()
        self.enc1 = ConvBlock(3, 16, device)
        self.enc2 = ConvBlock(16, 32, device)
        self.dec1 = ConvBlock(48, 16, device)
        self.final = nn.Conv2d(16, 1, 1, device=device)
        self.time1 = nn.Linear(latent_dim, latent_dim, device=device)
        self.time2 = nn.Linear(latent_dim, latent_dim, device=device)

    def forward(self, x, t, h_v, h_t, rows=None):
        """``rows``: the batch norms over every rank's rows of a batch split
        over the data axis."""
        B, d = x.shape
        H = math.isqrt(d)
        img = torch.stack([x.reshape(B, H, H), h_v.reshape(B, H, H), h_t.reshape(B, H, H)], dim=1)
        t_emb = self.time2(F.silu(self.time1(timestep_embedding(t, d)))).reshape(B, 1, H, H)
        e1 = self.enc1(img + t_emb, rows)
        e2 = self.enc2(e1, rows)
        d1 = self.dec1(torch.cat([e2, e1], dim=1), rows)
        return conv_gemm(self.final, d1).reshape(B, d)


class MCDRec(RecModel):
    def __init__(self, config, data):
        super().__init__(config, data)
        self.latent_dim = d = scalar(config["embedding_size"], int)
        if math.isqrt(d) ** 2 != d:
            raise ValueError("Embedding size must be a perfect square for U-Net reshaping")
        self.n_layers = scalar(config["lightGCN_n_layers"], int)
        self.lambda_dm = scalar(config["lambda_dm"])
        self.tau = scalar(config["tau"])
        self.rho = scalar(config["rho"])
        self.steps = scalar(config["steps"], int)
        dev = self.device
        self.ui = SampledUIGraph(data.users.cpu().numpy(), data.items.cpu().numpy(), self.n_users, self.n_items, dev)
        self.n_edges = self.ui.n_edges
        self.sched = make_schedule(
            "linear", scalar(config["noise_scale"]), scalar(config["noise_min"]), scalar(config["noise_max"]),
            self.steps, device=dev, beta_fixed=False,
        )
        self.user_emb = nn.Parameter(torch.empty(self.n_users, d, device=dev))
        self.item_emb = nn.Parameter(torch.empty(self.n_items, d, device=dev))
        self.unet = UNet(d, dev)
        self.v_mlp = nn.Linear(self.v_feat.shape[1], d, device=dev) if self.v_feat is not None else None
        self.t_mlp = nn.Linear(self.t_feat.shape[1], d, device=dev) if self.t_feat is not None else None

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """normal(0, 0.1) tables; convolutions U(±1/√fan_in) (torch's
        default); time and modal layers xavier-normal with zero biases."""
        self.user_emb.copy_(normal(self.user_emb.shape, 0.1, generator))
        self.item_emb.copy_(normal(self.item_emb.shape, 0.1, generator))
        for m in self.unet.modules():
            if isinstance(m, nn.Conv2d):
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                m.weight.copy_(uniform(m.weight.shape, bound, generator))
                m.bias.copy_(uniform(m.bias.shape, bound, generator))
            elif isinstance(m, Norm):
                m.g.fill_(1.0)
                m.bias.zero_()
        for layer in (self.unet.time1, self.unet.time2, self.v_mlp, self.t_mlp):
            if layer is not None:
                layer.weight.copy_(xavier_normal(layer.weight.shape, generator))
                layer.bias.zero_()

    def _modal_cond(self, idx=None):
        n = self.n_items if idx is None else idx.shape[0]
        pick = lambda f: f if idx is None else f[idx]
        v = self.v_mlp(pick(self.v_feat)) if self.v_mlp is not None else torch.zeros(n, self.latent_dim, device=self.device)
        t = self.t_mlp(pick(self.t_feat)) if self.t_mlp is not None else torch.zeros_like(v)
        return v, t

    def _norm_vals(self, keep: torch.Tensor) -> torch.Tensor:
        """The kept pairs' D^-½ A D^-½ values (a zero degree's factor 0), in
        the layout's edge order."""
        du = torch.zeros(self.n_users, device=keep.device).index_add_(0, self.ui.users, keep)
        di = torch.zeros(self.n_items, device=keep.device).index_add_(0, self.ui.items, keep)
        dis_u = torch.where(du > 0, du.clamp(min=1e-30).pow(-0.5), 0.0)
        dis_i = torch.where(di > 0, di.clamp(min=1e-30).pow(-0.5), 0.0)
        v = keep * dis_u[self.ui.users] * dis_i[self.ui.items]
        return torch.cat([v, v])[self.ui.perm]

    def init_state(self, generator=None) -> dict:
        return {"graph_vals": self._norm_vals(torch.ones(self.n_edges, device=self.device))}

    def dgd_draws(self, generator):
        """DGD's draws: the start (n_items, d), the noise of each reverse
        step (steps, n_items, d), in the loop's order, and the (n_edges,)
        uniforms."""
        dev, shape = self.device, (self.n_items, self.latent_dim)
        return dict(
            x=torch.randn(shape, generator=generator, device=dev),
            noise=torch.randn((self.steps,) + shape, generator=generator, device=dev),
            uniform=torch.rand(self.n_edges, generator=generator, device=dev),
        )

    @torch.no_grad()
    def reverse_items(self, x, noise):
        """The U-Net's reverse chain over every item from ``x``, with the
        posterior noise ``noise[j]`` at the j-th step (t = steps − 1 − j)."""
        h_v, h_t = self._modal_cond()
        for j, i in enumerate(range(self.steps - 1, -1, -1)):
            t = torch.full((self.n_items,), i, dtype=torch.int64, device=x.device)
            mean = q_posterior_mean(self.sched, self.unet(x, t, h_v, h_t), x, t)
            x = mean + float(i != 0) * _bcast(self.sched.posterior_variance, t, x).sqrt() * noise[j]
        return x

    @torch.no_grad()
    def dgd_keep(self, x_rev, uniform) -> torch.Tensor:
        """(n_edges,) 0/1: the pairs kept by the Gumbel top-k over the edge
        scores of the reverse-diffused items ``x_rev``."""
        diffused = self.item_emb + OMEGA * x_rev
        scores = (self.user_emb[self.ui.users] * diffused[self.ui.items]).sum(1)
        weights = F.relu(1.0 + self.tau * scores) + 1e-8
        sc = torch.log(weights) - torch.log(-torch.log(uniform + 1e-20) + 1e-20)
        n_keep = max(1, int(self.n_edges * (1.0 - self.rho)))
        thresh = torch.sort(sc).values[self.n_edges - n_keep]
        return (sc >= thresh).to(torch.float32)

    @torch.no_grad()
    def pre_epoch(self, state, generator, epoch: int, draws: Optional[dict] = None) -> dict:
        """DGD: this epoch's graph values. ``draws`` (``dgd_draws``) replace
        the draws."""
        if draws is None:
            draws = self.dgd_draws(generator)
        keep = self.dgd_keep(self.reverse_items(draws["x"], draws["noise"]), draws["uniform"])
        return {"graph_vals": self._norm_vals(keep)}

    def encode(self, state):
        out = layer_mean(self.ui.graph(state["graph_vals"]), torch.cat([self.user_emb, self.item_emb]), self.n_layers)
        return out[: self.n_users], out[self.n_users :]

    def draws(self, generator, batch_size: int):
        t = torch.randint(0, self.steps, (batch_size,), generator=generator, device=self.device)
        return t, torch.randn(batch_size, self.latent_dim, generator=generator, device=self.device)

    def loss(self, state, batch, generator=None, ts=None, noise=None):
        """``ts`` (B,) and ``noise`` (B, d) replace the draws. Over a data
        axis (``batch["rows"]``) the draws (given or made) are the global
        batch's and this rank takes its rows; the U-Net's batch norms take
        every rank's rows."""
        users, pos, neg, w = batch["users"], batch["pos"], batch["neg"], batch["weight"]
        rows = batch.get("rows")
        all_users, all_items = self.encode(state)
        u_e, p_e, n_e = all_users[users], all_items[pos], all_items[neg]
        bpr = weighted_mean(-torch.log(torch.sigmoid((u_e * p_e).sum(1) - (u_e * n_e).sum(1)) + 1e-12), w, rows)
        if ts is None:
            ts, noise = self.draws(generator, pos.shape[0] if rows is None else rows.n)
        if rows is not None:
            ts, noise = rows.local((ts, noise))
        x0 = self.item_emb[pos]
        h_v, h_t = self._modal_cond(pos)
        pred = self.unet(q_sample(self.sched, x0, ts, noise), ts, h_v, h_t, rows)
        dm = weighted_mean(((pred - x0) ** 2).mean(1), w, rows)
        total = bpr + self.lambda_dm * dm
        return total, (total,)

    def full_embeddings(self, state):
        return self.encode(state)
