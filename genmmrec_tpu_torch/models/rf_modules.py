"""The Rectified-Flow generator and the causal denoiser (counterpart of
``genmmrec_tpu/models/rf_modules.py``).

- ``RFConfig``: the generator's settings from the ``rf_*`` config keys.
- ``VelocityNet``: the sinusoidal time embedding ([sin, cos], frequencies
  over ``half - 1``), a condition encoder, residual blocks with layer norms
  (eps 1e-5), inverted dropout at five places and, in training only, the
  user-prior and cosine-gradient guidance, each decayed by
  ``(1 - t)^power``.
- ``rf_losses``: the straight-path loss ``‖v(X_t, t, c) − (X1 − X0)‖²``
  over every row of the target (all users and items), plus a sampled
  InfoNCE of the one-step endpoint ``X_t + (1 − t)·v`` against the target,
  items then users.
- ``generate``: the Euler ODE from a start noise, eval mode, no guidance,
  without an autograd graph; ``generate_staged`` / ``rf_losses_staged``
  with the 2-RF switch (a Python branch on the epoch: past
  ``rf_2rf_transition_epoch`` one step, and the loss on reflow pairs
  ``(z0, generate(z0))``).
- ``CausalDenoiser``: a propensity ``σ(α·cos(u, i) + β)`` over the train
  edges with its BCE (``ps_loss``), and an IPW-weighted GCN whose output
  every caller detaches. The GCN runs on K1 over one edge layout built at
  set-up (users to items and back, stably row-sorted), with the values of
  each call, and records no autograd graph: ``denoise_W`` has no gradient,
  as its gradient is zero in the JAX package.

Every draw can be passed in (``rf_draws``'s dict: the noise ``x0``, the
times ``t``, the dropout planes ``keep`` (bool), the InfoNCE negatives
``neg_items`` / ``neg_users`` before the collision fix, and ``z0`` for a
reflow pair); the tests pass the JAX package's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from genmmrec_tpu_torch.common.init import init_linear, xavier_normal, xavier_uniform
from genmmrec_tpu_torch.common.losses import table_share, weighted_mean
from genmmrec_tpu_torch.common.norm import Norm
from genmmrec_tpu_torch.ops.graph import sorted_graph, spmm

# the time embedding's width
TIME_DIM = 64


@dataclasses.dataclass
class RFConfig:
    embedding_dim: int
    hidden_dim: int = 128
    n_layers: int = 2
    dropout: float = 0.1
    learning_rate: float = 0.0001
    sampling_steps: int = 10
    user_guidance_scale: float = 0.2
    guidance_decay_power: float = 2.0
    cosine_guidance_scale: float = 0.1
    cosine_decay_power: float = 2.0
    warmup_epochs: int = 5
    train_mix_ratio: float = 0.1
    inference_mix_ratio: float = 0.2
    contrast_temp: float = 0.2
    contrast_weight: float = 1.0
    n_users: int = 0
    n_items: int = 0
    infonce_negative_samples: int = 1024
    use_2rf: bool = False
    rf_2rf_transition_epoch: int = 10

    @classmethod
    def from_config(cls, config, n_users: int, n_items: int, embedding_dim: int) -> "RFConfig":
        """The settings from the config; a value that is still a grid list
        takes its first entry, and ``rf_loss_weight`` is the InfoNCE weight."""

        def g(k, d):
            v = config[k] if config[k] is not None else d
            return v[0] if isinstance(v, list) else v

        return cls(
            embedding_dim=embedding_dim,
            hidden_dim=int(g("rf_hidden_dim", 128)),
            n_layers=int(g("rf_n_layers", 2)),
            dropout=float(g("rf_dropout", 0.1)),
            learning_rate=float(g("rf_learning_rate", 0.0001)),
            sampling_steps=int(g("rf_sampling_steps", 10)),
            user_guidance_scale=float(g("user_guidance_scale", 0.2)),
            guidance_decay_power=float(g("guidance_decay_power", 2.0)),
            cosine_guidance_scale=float(g("cosine_guidance_scale", 0.1)),
            cosine_decay_power=float(g("cosine_decay_power", 2.0)),
            warmup_epochs=int(g("rf_warmup_epochs", 5)),
            train_mix_ratio=float(g("rf_mix_ratio", 0.1)),
            inference_mix_ratio=float(g("rf_inference_mix_ratio", 0.2)),
            contrast_temp=float(g("rf_contrast_temp", 0.2)),
            contrast_weight=float(g("rf_loss_weight", 1.0)),
            n_users=n_users,
            n_items=n_items,
            infonce_negative_samples=int(g("infonce_negative_samples", 1024)),
            use_2rf=bool(g("use_2rf", False)),
            rf_2rf_transition_epoch=int(g("rf_2rf_transition_epoch", int(g("rf_warmup_epochs", 5)) + 5)),
        )

    def reflows(self, epoch: int) -> bool:
        """Whether ``epoch`` trains on reflow pairs and samples in one step."""
        return self.use_2rf and epoch >= self.rf_2rf_transition_epoch

    def n_negatives(self, n_rows: int) -> int:
        return min(self.infonce_negative_samples, max(n_rows - 1, 1))


def sinusoidal_time_embedding(t: torch.Tensor, dim: int = TIME_DIM) -> torch.Tensor:
    """(B, 1) times in [0, 1] -> (B, dim): [sin, cos] of ``t · exp(-j·ln(1e4)/(half-1))``."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device) * -(math.log(10000.0) / (half - 1)))
    emb = t * freqs[None, :]
    return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)


def cosine_similarity_gradient(x_t: torch.Tensor, x_1: torch.Tensor) -> torch.Tensor:
    """∇_{x_t} cos(x_t, x_1) in closed form, norms floored at 1e-8."""
    eps = 1e-8
    xt_norm = torch.linalg.vector_norm(x_t, dim=-1, keepdim=True).clamp(min=eps)
    x1n = x_1 / torch.linalg.vector_norm(x_1, dim=-1, keepdim=True).clamp(min=eps)
    xtn = x_t / xt_norm
    cos = (xtn * x1n).sum(-1, keepdim=True)
    return x1n / xt_norm - xtn * cos / xt_norm


def _l2n(x: torch.Tensor) -> torch.Tensor:
    """Each row over max(its L2 norm, 1e-12)."""
    return F.normalize(x, dim=-1, eps=1e-12)


class _ResBlock(nn.Module):
    def __init__(self, h: int, device):
        super().__init__()
        self.l1 = nn.Linear(h, h, device=device)
        self.ln1 = Norm(h).to(device)
        self.l2 = nn.Linear(h, h, device=device)
        self.ln2 = Norm(h).to(device)


class VelocityNet(nn.Module):
    """The velocity field v(x, t, c) under the JAX tree's names."""

    def __init__(self, cfg: RFConfig, condition_dim: int, device):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_dim
        self.time_lin = nn.Linear(TIME_DIM, h, device=device)
        self.cond_lin = nn.Linear(condition_dim, h, device=device)
        self.cond_ln = Norm(h).to(device)
        self.in_lin = nn.Linear(cfg.embedding_dim, h, device=device)
        self.in_ln = Norm(h).to(device)
        self.res_blocks = nn.ModuleList(_ResBlock(h, device) for _ in range(cfg.n_layers))
        self.out_lin1 = nn.Linear(h, h, device=device)
        self.out_ln = Norm(h).to(device)
        self.out_lin2 = nn.Linear(h, cfg.embedding_dim, device=device)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """xavier_uniform weights, zero biases, unit norms."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                init_linear(m, generator, init=xavier_uniform, zero_bias=True)
            elif isinstance(m, Norm):
                m.g.fill_(1.0)
                m.bias.zero_()

    def forward(self, x, t, conditions, train: bool = False, keep=None, user_prior=None, x_1=None):
        cfg = self.cfg
        rate = cfg.dropout

        def drop(i, z):
            if not train or keep is None or rate <= 0:
                return z
            return torch.where(keep[i], z / (1.0 - rate), 0.0)

        t_emb = drop(0, F.silu(self.time_lin(sinusoidal_time_embedding(t))))
        cond = drop(1, F.silu(self.cond_ln.layer_norm(self.cond_lin(conditions))))
        hcur = drop(2, F.silu(self.in_ln.layer_norm(self.in_lin(x))))
        hcur = hcur + t_emb + cond
        for i, b in enumerate(self.res_blocks):
            inner = b.ln1.layer_norm(b.l1(hcur))
            inner = drop(3 + i, F.silu(inner))
            inner = b.ln2.layer_norm(b.l2(inner))
            hcur = F.silu(inner + hcur)
        out = F.silu(self.out_ln.layer_norm(self.out_lin1(hcur)))
        out = drop(3 + cfg.n_layers, out)
        v = self.out_lin2(out)
        if train:
            if user_prior is not None:
                v = v + (1.0 - t) ** cfg.guidance_decay_power * cfg.user_guidance_scale * user_prior
            if x_1 is not None:
                guide = cosine_similarity_gradient(x, x_1)
                v = v + (1.0 - t) ** cfg.cosine_decay_power * cfg.cosine_guidance_scale * guide
        return v


def rf_draws(cfg: RFConfig, generator, n_rows: int, batch_size: int, device, epoch: int = 0) -> dict:
    """One training call's draws: ``x0`` (n_rows, d) normals (``z0`` of the
    reflow pair past the 2-RF switch), ``t`` (n_rows, 1) uniforms, the
    ``n_layers + 4`` bool dropout planes ``keep`` (time, condition, input,
    one a block, output; (n_rows, hidden) each, keep rate 1 − dropout; None
    without dropout), and the (B, n_neg) negatives ``neg_items`` /
    ``neg_users``."""
    rnd = lambda *s: torch.rand(s, generator=generator, device=device)
    out = {"z0" if cfg.reflows(epoch) else "x0": torch.randn(n_rows, cfg.embedding_dim, generator=generator,
                                                            device=device)}
    out["t"] = rnd(n_rows, 1)
    out["keep"] = None
    if cfg.dropout > 0:
        out["keep"] = tuple(rnd(n_rows, cfg.hidden_dim) < 1.0 - cfg.dropout for _ in range(cfg.n_layers + 4))
    for name, n in (("neg_items", cfg.n_items), ("neg_users", cfg.n_users)):
        out[name] = torch.randint(0, n, (batch_size, cfg.n_negatives(n)), generator=generator, device=device)
    return out


def infonce_sampled(rf_embeds, target_embeds, pos_indices, cfg: RFConfig, neg_idx, weights, rows=None) -> torch.Tensor:
    """Sampled-negative InfoNCE: each row's positive against ``neg_idx``'s
    rows of the normalized target; a negative equal to its positive moves
    to ``(idx + 1) % N``. The weighted mean is over ``max(Σw, 1)``, over
    ``rows`` the global batch's Σw."""
    N = target_embeds.shape[0]
    rf_pos = _l2n(rf_embeds[pos_indices])
    tgt = _l2n(target_embeds)
    pos_score = torch.exp((rf_pos * tgt[pos_indices]).sum(-1) / cfg.contrast_temp)
    neg_idx = torch.where(neg_idx == pos_indices[:, None], (neg_idx + 1) % N, neg_idx)
    tgt_neg = tgt[neg_idx]  # (B, n_neg, d)
    neg_scores = torch.exp(torch.bmm(tgt_neg, rf_pos[:, :, None])[:, :, 0] / cfg.contrast_temp)
    per = -torch.log(pos_score / (pos_score + neg_scores.sum(1)))
    return weighted_mean(per, weights, rows)


def rf_losses(net: VelocityNet, target, conditions, user_prior, users, pos, weights, draws: dict, fixed_noise=None,
              rows=None):
    """(total, flow loss, InfoNCE) over every row of ``target`` (users
    then items, detached by the caller). Over ``rows`` (this rank's rows of
    a batch split over the data axis) the draws are the global batch's: the
    flow, over every table row, is this rank's share, and each row of the
    batch takes its row of the negatives."""
    cfg = net.cfg
    X1 = target
    X0 = fixed_noise if fixed_noise is not None else draws["x0"]
    t = draws["t"]
    X_t = t * X1 + (1.0 - t) * X0
    v = net(X_t, t, conditions, train=True, keep=draws["keep"], user_prior=user_prior, x_1=X1)
    flow = table_share(((v - (X1 - X0)) ** 2).mean(), rows)
    pred_x1 = X_t + (1.0 - t) * v
    n_u = cfg.n_users
    neg_items, neg_users = (draws[k] if rows is None else rows.local(draws[k]) for k in ("neg_items", "neg_users"))
    cl = infonce_sampled(pred_x1[n_u:], X1[n_u:], pos, cfg, neg_items, weights, rows) + infonce_sampled(
        pred_x1[:n_u], X1[:n_u], users, cfg, neg_users, weights, rows
    )
    return flow + cfg.contrast_weight * cl, flow, cl


@torch.no_grad()
def generate(net: VelocityNet, conditions, n_steps: Optional[int] = None, start_noise=None, generator=None):
    """Euler ODE from ``start_noise`` (else normals from ``generator``) over
    ``n_steps`` (else ``sampling_steps``), eval mode."""
    cfg = net.cfg
    n_steps = n_steps or cfg.sampling_steps
    B = conditions.shape[0]
    z = start_noise
    if z is None:
        z = torch.randn(B, cfg.embedding_dim, generator=generator, device=conditions.device)
    dt = torch.tensor(1.0 / n_steps, dtype=torch.float32, device=conditions.device)
    steps = torch.arange(n_steps, dtype=torch.float32, device=conditions.device) * dt
    for i in range(n_steps):
        v = net(z, steps[i].expand(B, 1), conditions)
        z = z + v * dt
    return z


def seeded_start_noise(cfg: RFConfig, n_rows: int, device, start_noise=None):
    """An evaluation's start noise: ``start_noise``, else (n_rows, d) normals
    from a generator seeded 0 on ``device``."""
    if start_noise is not None:
        return start_noise
    gen = torch.Generator(device=device).manual_seed(0)
    return torch.randn(n_rows, cfg.embedding_dim, generator=gen, device=device)


@torch.no_grad()
def prepare_reflow(net: VelocityNet, conditions, z0):
    """The reflow pair (z0, generate(z0)) of the current field."""
    return z0, generate(net, conditions, start_noise=z0)


def generate_staged(net: VelocityNet, conditions, epoch: int, start_noise=None, generator=None):
    """``generate``, in one step once the 2-RF switch has passed."""
    n_steps = 1 if net.cfg.reflows(epoch) else None
    return generate(net, conditions, n_steps=n_steps, start_noise=start_noise, generator=generator)


def rf_losses_staged(net: VelocityNet, epoch: int, target, conditions, user_prior, users, pos, weights, draws: dict,
                     fixed_noise=None, rows=None):
    """``rf_losses`` on the target before the 2-RF switch; past it on the
    reflow pair from ``draws["z0"]`` (the field frozen for the pair; over
    the table's rows, the same on every rank of a data axis)."""
    if net.cfg.reflows(epoch):
        z0, z1 = prepare_reflow(net, conditions, draws["z0"])
        return rf_losses(net, z1, conditions, user_prior, users, pos, weights, draws, fixed_noise=z0, rows=rows)
    return rf_losses(net, target, conditions, user_prior, users, pos, weights, draws, fixed_noise=fixed_noise,
                     rows=rows)


def mix_embeddings(cfg: RFConfig, original, generated, training: bool, epoch: int):
    """The originals in training, during the warm-up or without a
    generation; ``original + inference_mix_ratio · generated`` otherwise."""
    if training or generated is None or epoch < cfg.warmup_epochs:
        return original
    return original + cfg.inference_mix_ratio * generated


# ----------------------------------------------------------------------
class CausalDenoiser(nn.Module):
    """The IPW denoiser over the train interactions ``users``/``items``
    (numpy, duplicates kept), parameters ``{alpha, beta, denoise_W: [{w,
    b}]}``."""

    def __init__(self, users, items, n_users: int, n_items: int, dim: int, n_layers: int, device):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones((), device=device))
        self.beta = nn.Parameter(torch.zeros((), device=device))
        self.denoise_W = nn.ModuleList(nn.Linear(dim, dim, device=device) for _ in range(n_layers))
        self.n_users, self.n_items = n_users, n_items
        self.users = torch.as_tensor(users, dtype=torch.int64, device=device)
        self.items = torch.as_tensor(items, dtype=torch.int64, device=device)
        # every caller passes unit treatments (the train edges are clean)
        self.treatments = torch.ones(self.users.shape[0], device=device)
        rows = torch.cat([self.users, self.items + n_users])
        cols = torch.cat([self.items + n_users, self.users])
        rows, self.perm = torch.sort(rows, stable=True)
        N = n_users + n_items
        self.layout = sorted_graph(rows, cols[self.perm], torch.zeros(rows.shape[0], device=device), N, N,
                                   symmetric=True)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        self.alpha.fill_(1.0)
        self.beta.zero_()
        for layer in self.denoise_W:
            layer.weight.copy_(xavier_normal(layer.weight.shape, generator))
            layer.bias.zero_()

    def propensity(self, ego: torch.Tensor) -> torch.Tensor:
        """(E,) ``σ(α·cos(u, i) + β)`` of each train edge."""
        nu = self.n_users
        u_emb, i_emb = _l2n(ego[:nu]), _l2n(ego[nu:])
        sim = (u_emb[self.users] * i_emb[self.items]).sum(1)
        return torch.sigmoid(self.alpha * sim + self.beta)

    @torch.no_grad()
    def ipw_graph(self, e_scores: torch.Tensor):
        """The layout with the IPW values ``T / (e + 1e-8)`` on both
        directions of each edge."""
        ipw = self.treatments / (e_scores + 1e-8)
        return dataclasses.replace(self.layout, vals=torch.cat([ipw, ipw])[self.perm])

    def forward(self, ego: torch.Tensor):
        """(denoised (N, d) without an autograd graph, ps_loss)."""
        e_scores = self.propensity(ego)
        e_c = e_scores.clamp(1e-7, 1 - 1e-7)
        T = self.treatments
        ps_loss = -(T * torch.log(e_c) + (1 - T) * torch.log(1 - e_c)).mean()
        with torch.no_grad():
            g = self.ipw_graph(e_scores)
            deg = torch.zeros(g.n_rows, device=ego.device).index_add_(0, g.rows.long(), g.vals) + 1e-8
            d_inv_sqrt = deg**-0.5
            x = ego.detach()
            acc = x
            for layer in self.denoise_W:
                x = F.relu(layer(d_inv_sqrt[:, None] * spmm(g, x)))
                acc = acc + x
            denoised = acc / (len(self.denoise_W) + 1)
        return denoised, ps_loss
