"""MVGAE: multimodal variational graph auto-encoder (counterpart of
``genmmrec_tpu/models/mvgae.py``).

Three GCN towers (visual, text, collaborative) each give (μ, log σ²):
``mean`` propagation (K1) over the self-looped symmetric user-item edges,
each conv ``x @ W`` with ``W`` in the JAX package's (in, out) layout, then
``+ b``, the row normalization and, in training, dropout p = 0.1. The
modalities fuse by a two-stage product of experts (visual with text, then
with the collaborative tower); z is reparameterized with 0.1-scaled noise.
The loss sums over {fused, v, t, c} the sum-reduced log₂-BPR of σ(z)
scores plus β·KL.

Every draw can be passed in, so that a test can inject the JAX package's:
``keep`` maps each tower (``v``, ``t``, ``c``) to its four bool dropout
planes (N, d) (conv1, conv2, conv4, conv5; conv2's is drawn and read only
with ``n_layers`` > 1), ``noise`` maps ``z``, ``v``, ``t``, ``c`` to an
(N, d) standard normal. What is not passed is drawn from the generator.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from genmmrec_tpu_torch.common.init import init_linear, uniform, xavier_normal
from genmmrec_tpu_torch.common.losses import table_share
from genmmrec_tpu_torch.common.norm import l2n
from genmmrec_tpu_torch.models.base import RecModel, scalar
from genmmrec_tpu_torch.ops.graph import unique_ui_pairs
from genmmrec_tpu_torch.ops.mp import message_graph, propagate, sort_edges_by_dst

MAX_LOGVAR = 10.0
KEEP = 0.9
CONVS = ("conv1", "conv2", "conv4", "conv5")
TOWERS = ("v", "t", "c")


def lrelu(x):
    return F.leaky_relu(x, 0.01)


class _Conv(nn.Module):
    """``x @ weight + bias`` with weight (in, out): not an ``nn.Linear``."""

    def __init__(self, d_in: int, d_out: int, device):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_in, d_out, device=device))
        self.bias = nn.Parameter(torch.empty(d_out, device=device))

    @torch.no_grad()
    def init_params(self, generator):
        bound = 1.0 / math.sqrt(self.weight.shape[0])
        self.weight.copy_(uniform(self.weight.shape, bound, generator))
        self.bias.copy_(uniform(self.bias.shape, bound, generator))


class _Tower(nn.Module):
    def __init__(self, n_users: int, dim_feat: int, d: int, dl: int, device):
        super().__init__()
        self.preference = nn.Parameter(torch.empty(n_users, dl, device=device))
        self.mlp = nn.Linear(dim_feat, dl, device=device)
        for name, d_in in (("conv1", dl), ("conv2", d), ("conv4", d), ("conv5", d)):
            setattr(self, name, _Conv(d_in, d, device))
        for name in ("g1", "g2", "lin4", "g4", "lin5", "g5"):
            setattr(self, name, nn.Linear(d, d, device=device))

    @torch.no_grad()
    def init_params(self, generator):
        self.preference.copy_(xavier_normal(self.preference.shape, generator))
        for name, module in self.named_children():
            if isinstance(module, _Conv):
                module.init_params(generator)
            else:
                init_linear(module, generator, zero_bias=True)


class MVGAE(RecModel):
    def __init__(self, config, data):
        super().__init__(config, data)
        self.dim_x = scalar(config["embedding_size"], int)
        self.num_layer = scalar(config["n_layers"], int)
        self.beta = scalar(config["beta"])
        self.dim_latent = 128
        self.N = self.n_users + self.n_items
        dev = self.device
        users, items = unique_ui_pairs(data.users.cpu().numpy(), data.items.cpu().numpy())
        items = items + self.n_users
        loops = np.arange(self.N)
        src, dst = sort_edges_by_dst(np.concatenate([users, items, loops]), np.concatenate([items, users, loops]))
        # unit values on mirrored edges: the backward runs on the same edges
        self.graph = message_graph(src, dst, self.N, dev, symmetric=True)
        self.collaborative = nn.Parameter(torch.empty(self.n_items, self.dim_x, device=dev))
        feats = {"v": self.v_feat.shape[1], "t": self.t_feat.shape[1], "c": self.dim_x}
        for m in TOWERS:
            setattr(self, f"{m}_gcn", _Tower(self.n_users, feats[m], self.dim_x, self.dim_latent, dev))

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        self.collaborative.copy_(xavier_normal(self.collaborative.shape, generator))
        for m in TOWERS:
            getattr(self, f"{m}_gcn").init_params(generator)

    def _conv(self, conv, x, keep=None):
        h = l2n(propagate(x @ conv.weight, self.graph, "mean") + conv.bias)
        return h if keep is None else torch.where(keep, h / KEEP, 0.0)

    def _tower(self, tp, features, keep):
        lin = lambda name, x: getattr(tp, name)(x)
        x = l2n(torch.cat([tp.preference, tp.mlp(features)]))
        if self.num_layer > 0:
            x = lrelu(lin("g1", lrelu(self._conv(tp.conv1, x, keep[0]))))
        if self.num_layer > 1:
            x = lrelu(lin("g2", lrelu(self._conv(tp.conv2, x, keep[1]))))
        mu = lin("g4", lrelu(self._conv(tp.conv4, x, keep[2]))) + lrelu(lin("lin4", x))
        logvar = lin("g5", lrelu(self._conv(tp.conv5, x, keep[3]))) + lrelu(lin("lin5", x))
        return mu, logvar

    @staticmethod
    def _poe(mus, logvars, eps=1e-8):
        T = 1.0 / (torch.exp(torch.stack(logvars)) + eps)
        pd_mu = (torch.stack(mus) * T).sum(0) / T.sum(0)
        return pd_mu, torch.log(1.0 / T.sum(0))

    def forward(self, keep=None):
        """(fused μ, fused log σ², {tower: (μ, log σ²)}); ``keep`` as in the
        module docstring, or None for no dropout."""
        feats = {"v": self.v_feat, "t": self.t_feat, "c": self.collaborative}
        towers = {
            m: self._tower(getattr(self, f"{m}_gcn"), feats[m], keep[m] if keep is not None else (None,) * 4)
            for m in TOWERS
        }
        (v_mu, v_lv), (t_mu, t_lv), (c_mu, c_lv) = (towers[m] for m in TOWERS)
        pd_mu, pd_lv = self._poe([v_mu, t_mu], [v_lv, t_lv])
        pd_mu, pd_lv = self._poe([pd_mu, c_mu], [pd_lv, c_lv])
        return pd_mu, pd_lv, towers

    def draws(self, generator):
        """A draw of every dropout plane and noise the loss reads."""
        shape = (self.N, self.dim_x)
        rand = lambda: torch.rand(shape, generator=generator, device=self.device) < KEEP
        keep = {m: tuple(rand() for _ in CONVS) for m in TOWERS}
        noise = {m: torch.randn(shape, generator=generator, device=self.device) for m in ("z",) + TOWERS}
        return keep, noise

    @staticmethod
    def _reparam(mu, logvar, noise):
        return mu + noise * 0.1 * torch.exp(0.5 * logvar.clamp(max=MAX_LOGVAR))

    def _recon(self, z, users, pos, neg, weights):
        z = torch.sigmoid(z)
        pos_s = torch.sigmoid((z[users] * z[pos + self.n_users]).sum(1))
        neg_s = torch.sigmoid((z[users] * z[neg + self.n_users]).sum(1))
        return (-torch.log2(torch.sigmoid(pos_s - neg_s) + 1e-12) * weights).sum()

    @staticmethod
    def _kl(mu, logvar):
        logvar = logvar.clamp(max=MAX_LOGVAR)
        return -0.5 * (1 + logvar - mu**2 - torch.exp(logvar)).sum(1).mean()

    def loss(self, state, batch, generator=None, keep=None, noise=None):
        """Over a data axis (``batch["rows"]``) the draws, over whole tables,
        are the same on every rank; the reconstruction sums this rank's rows
        and the KL, over every node, is shared."""
        users, pos, neg, w = batch["users"], batch["pos"], batch["neg"], batch["weight"]
        rows = batch.get("rows")
        if keep is None or noise is None:
            drawn_keep, drawn_noise = self.draws(generator)
            keep, noise = keep or drawn_keep, noise or drawn_noise
        pd_mu, pd_lv, towers = self.forward(keep)
        total = 0.0
        for name, (mu, lv) in (("z", (pd_mu, pd_lv)), *((m, towers[m]) for m in TOWERS)):
            z = self._reparam(mu, lv, noise[name])
            total = total + self._recon(z, users, pos, neg, w) + self.beta * table_share(self._kl(mu, lv), rows)
        return total, (total,)

    def full_embeddings(self, state):
        pd_mu, _, _ = self.forward()
        result = torch.sigmoid(pd_mu)
        return result[: self.n_users], result[self.n_users :]
