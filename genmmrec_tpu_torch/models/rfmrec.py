"""RFMRec: the standalone Rectified-Flow multimodal recommender
(counterpart of ``genmmrec_tpu/models/rfmrec.py``; ``RFMREC`` is an
alias).

- Conditions of a batch: the two-layer mean over the weighted bipartite
  adjacency (duplicate pairs keep their multiplicity; K1 forward and
  backward, so they carry the gradient into both tables) of the user and
  the item, and the item's projected visual and text features.
- The velocity net (hidden 512, 6 layers, 8 heads at the published
  config): a deep time embedding, three condition encoders, per layer a
  cross-attention over the (≤ 3) condition tokens with its FFN, a
  self-attention over one token, an AdaGN-modulated residual block
  (group norm of 8 groups, population variance) with a learnable skip
  scale, and a mid-layer skip fusion. The attention keeps Q, K and V as
  three (d, d) weights and drops out the probabilities, as the JAX
  package's ``_mha``: plain projections and einsums.
- Loss: ``λ_rf``·the straight-path flow error of (user ⊕ item) of each
  row, weighted, + ``λ_rec``·BPR + the regularizer.
- Scores: the embedding tables. ``generate`` (the Euler ODE) is not on the
  evaluation path.

Linear layers take ``nn.Linear``'s default initialization. ``loss`` takes
its draws as ``draws``: ``x0`` (B, 2d), ``t`` (B, 1) and ``keep``, the bool
dropout planes by name (``velocity_draws``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from genmmrec_tpu_torch.common.init import init_linear, kaiming_uniform_default, uniform, xavier_uniform
from genmmrec_tpu_torch.common.losses import weighted_mean
from genmmrec_tpu_torch.common.norm import Norm
from genmmrec_tpu_torch.models.base import RecModel, scalar
from genmmrec_tpu_torch.models.rf_modules import sinusoidal_time_embedding
from genmmrec_tpu_torch.ops.graph import bipartite_norm_adj, spmm

N_HEADS = 8
TIME_DIM = 256
GROUPS = 8


class _MHA(nn.Module):
    """Multi-head attention with three (d, d) projections, as the JAX tree."""

    def __init__(self, d: int, device):
        super().__init__()
        for name in ("wq", "wk", "wv", "wo"):
            setattr(self, name, nn.Parameter(torch.empty(d, d, device=device)))
        for name in ("bq", "bk", "bv", "bo"):
            setattr(self, name, nn.Parameter(torch.zeros(d, device=device)))

    @torch.no_grad()
    def init_params(self, generator):
        """``nn.MultiheadAttention``'s: one (3d, d) xavier bound for Q, K, V,
        zero biases, the output projection's ``nn.Linear`` default."""
        d = self.wq.shape[0]
        for name in ("wq", "wk", "wv"):
            getattr(self, name).copy_(uniform((d, d), math.sqrt(6.0 / (4 * d)), generator))
        self.wo.copy_(kaiming_uniform_default((d, d), generator))
        for name in ("bq", "bk", "bv", "bo"):
            getattr(self, name).zero_()

    def forward(self, q, kv, keep=None, rate: float = 0.0):
        B, Lq, d = q.shape
        Lk, H = kv.shape[1], N_HEADS
        dh = d // H
        Q = (q @ self.wq.T + self.bq).reshape(B, Lq, H, dh)
        K = (kv @ self.wk.T + self.bk).reshape(B, Lk, H, dh)
        V = (kv @ self.wv.T + self.bv).reshape(B, Lk, H, dh)
        att = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", Q, K) / math.sqrt(dh), dim=-1)
        att = _drop(att, keep, rate)
        out = torch.einsum("bhqk,bkhd->bqhd", att, V).reshape(B, Lq, d)
        return out @ self.wo.T + self.bo


def _ln(p: Norm, x):
    """Layer norm as the JAX package writes it: the population variance of
    the centred row, ``(x − μ)/sqrt(var + 1e-5)·g + b``."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-5) * p.g + p.bias


def _drop(x, keep, rate: float):
    """Inverted dropout by the bool plane ``keep``; None is eval mode."""
    if keep is None or rate <= 0.0:
        return x
    return torch.where(keep, x / (1.0 - rate), 0.0)


class _CondEncoder(nn.Module):
    def __init__(self, d_in: int, h: int, device):
        super().__init__()
        self.layers = nn.ModuleList(nn.ModuleDict({"lin": nn.Linear(a, h, device=device), "ln": Norm(h).to(device)})
                                    for a in (d_in, h))
        if d_in != h:
            self.skip = nn.Linear(d_in, h, device=device)

    def forward(self, x, keeps, rate):
        skip = self.skip(x) if hasattr(self, "skip") else x
        hcur = x
        for layer, keep in zip(self.layers, keeps):
            hcur = _drop(F.silu(_ln(layer["ln"], layer["lin"](hcur))), keep, rate)
        return hcur + skip


class _Cross(nn.Module):
    def __init__(self, h, device):
        super().__init__()
        self.attn = _MHA(h, device)
        self.ln1, self.ln2 = Norm(h).to(device), Norm(h).to(device)
        self.ffn1 = nn.Linear(h, 4 * h, device=device)
        self.ffn2 = nn.Linear(4 * h, h, device=device)


class _SelfAttn(nn.Module):
    def __init__(self, h, device):
        super().__init__()
        self.attn = _MHA(h, device)
        self.ln = Norm(h).to(device)


class _Res(nn.Module):
    def __init__(self, h, device):
        super().__init__()
        self.net1 = nn.Linear(h, 2 * h, device=device)
        self.net2 = nn.Linear(2 * h, h, device=device)
        self.gn = Norm(h).to(device)
        for name in ("scale1", "scale2", "shift1", "shift2"):
            setattr(self, name, nn.Linear(h, h, device=device))
        self.ln = Norm(h).to(device)


class _Mid(nn.Module):
    def __init__(self, h, device):
        super().__init__()
        self.lin = nn.Linear(h, h, device=device)
        self.ln = Norm(h).to(device)


class _Velocity(nn.Module):
    def __init__(self, d: int, h: int, n_layers: int, v_dim: int, t_dim: int, device):
        super().__init__()
        d2 = 2 * d
        self.time1 = nn.Linear(TIME_DIM, h, device=device)
        self.time2 = nn.Linear(h, h, device=device)
        self.time3 = nn.Linear(h, h, device=device)
        self.enc_interaction = _CondEncoder(d2, h, device)
        self.enc_visual = _CondEncoder(d, h, device)
        self.enc_text = _CondEncoder(d, h, device)
        self.in_lin = nn.Linear(d2, h, device=device)
        self.in_ln = Norm(h).to(device)
        self.out_lin1 = nn.Linear(h, h, device=device)
        self.out_ln = Norm(h).to(device)
        self.out_lin2 = nn.Linear(h, d2, device=device)
        self.skip_scale = nn.Parameter(torch.ones(n_layers, device=device))
        self.cross = nn.ModuleList(_Cross(h, device) for _ in range(n_layers))
        self.selfa = nn.ModuleList(_SelfAttn(h, device) for _ in range(n_layers))
        self.res = nn.ModuleList(_Res(h, device) for _ in range(n_layers))
        self.mid = nn.ModuleList(_Mid(h, device) for _ in range(n_layers // 2))


class RFMRec(RecModel):
    def __init__(self, config, data):
        super().__init__(config, data)
        d = self.embedding_dim = scalar(config["embedding_size"], int)
        h = self.hidden_dim = scalar(config["rf_hidden_dim"], int, default=256)
        self.n_layers = scalar(config["rf_n_layers"], int, default=2)
        self.dropout = scalar(config["rf_dropout"], default=0.1)
        self.reg_weight = scalar(config["reg_weight"])
        self.n_sampling_steps = scalar(config["rf_sampling_steps"], int, default=10)
        self.use_reflow = bool(config["rf_use_reflow"])
        self.lambda_rf = scalar(config["lambda_rf"], default=1.0)
        self.lambda_rec = scalar(config["lambda_rec"], default=1.0)
        dev = self.device
        # weighted: duplicate (u, i) pairs keep their multiplicity
        self.norm_adj = bipartite_norm_adj(data.users.cpu().numpy(), data.items.cpu().numpy(), self.n_users,
                                           self.n_items, dev, weighted=True)
        self.user_embedding = nn.Parameter(torch.empty(self.n_users, d, device=dev))
        self.item_embedding = nn.Parameter(torch.empty(self.n_items, d, device=dev))
        self.visual_proj = nn.Linear(self.v_feat.shape[1], d, device=dev)
        self.text_proj = nn.Linear(self.t_feat.shape[1], d, device=dev)
        self.velocity = _Velocity(d, h, self.n_layers, self.v_feat.shape[1], self.t_feat.shape[1], dev)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        self.user_embedding.copy_(xavier_uniform(self.user_embedding.shape, generator))
        self.item_embedding.copy_(xavier_uniform(self.item_embedding.shape, generator))
        for m in self.modules():
            if isinstance(m, nn.Linear):
                init_linear(m, generator, init=kaiming_uniform_default)
            elif isinstance(m, _MHA):
                m.init_params(generator)
            elif isinstance(m, Norm):
                m.g.fill_(1.0)
                m.bias.zero_()
        self.velocity.skip_scale.fill_(1.0)

    # ------------------------------------------------------------------
    def velocity_draws(self, generator, B: int) -> dict:
        """The bool dropout planes of one training call of B rows, by name."""
        h, keep = self.hidden_dim, 1.0 - self.dropout
        plane = lambda *s: torch.rand(s, generator=generator, device=self.device) < keep
        out = {"time": plane(B, h), "in": plane(B, h), "out": plane(B, h)}
        for enc in ("interaction", "visual", "text"):
            out[f"enc_{enc}"] = (plane(B, h), plane(B, h))
        for i in range(self.n_layers):
            out[f"cross{i}_attn"] = plane(B, N_HEADS, 1, 3)
            out[f"cross{i}_ffn1"] = plane(B, 1, 4 * h)
            out[f"cross{i}_ffn2"] = plane(B, 1, h)
            out[f"selfa{i}_attn"] = plane(B, N_HEADS, 1, 1)
            out[f"res{i}_net1"] = plane(B, 2 * h)
        return out

    def _group_norm(self, x, p: Norm):
        B, d = x.shape
        g = x.reshape(B, GROUPS, d // GROUPS)
        mu = g.mean(dim=2, keepdim=True)
        var = g.var(dim=2, keepdim=True, unbiased=False)
        g = (g - mu) / torch.sqrt(var + 1e-5)
        return g.reshape(B, d) * p.g + p.bias

    def velocity_of(self, x, t, conditions, keep=None):
        """v(x, t, c); ``keep`` None is eval mode (no dropout)."""
        vp, dr = self.velocity, self.dropout
        k = (lambda name: None) if keep is None else keep.get
        t_emb = _drop(F.silu(vp.time1(sinusoidal_time_embedding(t, TIME_DIM))), k("time"), dr)
        t_emb = vp.time3(F.silu(vp.time2(t_emb)))
        no = (None, None)
        cond_feats = [
            getattr(vp, f"enc_{c}")(conditions[c], (keep or {}).get(f"enc_{c}", no), dr)
            for c in ("interaction", "visual", "text")
        ]
        cond_stack = torch.stack(cond_feats, dim=1)  # (B, 3, h)
        cond_agg = cond_stack.mean(dim=1) + t_emb
        hcur = _drop(F.silu(_ln(vp.in_ln, vp.in_lin(x))), k("in"), dr)
        skips = []
        for i in range(self.n_layers):
            if i < len(vp.mid):
                skips.append(F.silu(_ln(vp.mid[i].ln, vp.mid[i].lin(hcur))))
            cp = vp.cross[i]
            q = hcur[:, None, :]
            att = cp.attn(q, cond_stack, k(f"cross{i}_attn"), dr)
            q2 = _ln(cp.ln1, q + att)
            ffn = _drop(F.gelu(cp.ffn1(q2)), k(f"cross{i}_ffn1"), dr)
            ffn = _drop(cp.ffn2(ffn), k(f"cross{i}_ffn2"), dr)
            hcur = hcur + _ln(cp.ln2, q2 + ffn)[:, 0, :]
            sp = vp.selfa[i]
            sa = sp.attn(hcur[:, None, :], hcur[:, None, :], k(f"selfa{i}_attn"), dr)
            hcur = hcur + _ln(sp.ln, hcur[:, None, :] + sa)[:, 0, :]
            rp = vp.res[i]
            hr = rp.net2(_drop(F.gelu(rp.net1(hcur)), k(f"res{i}_net1"), dr))
            hr = self._group_norm(hr, rp.gn)
            scale = rp.scale2(F.silu(rp.scale1(cond_agg)))
            shift = rp.shift2(F.silu(rp.shift1(cond_agg)))
            hr = _ln(rp.ln, scale * hr + shift) + hcur
            hcur = hcur + vp.skip_scale[i] * hr
        if skips:
            hcur = hcur + torch.stack(skips, 0).mean(0)
        out = _drop(F.silu(_ln(vp.out_ln, vp.out_lin1(hcur))), k("out"), dr)
        return vp.out_lin2(out)

    # ------------------------------------------------------------------
    def conditions(self, users, items):
        x = torch.cat([self.user_embedding, self.item_embedding])
        acc = x
        for _ in range(2):
            x = spmm(self.norm_adj, x)
            acc = acc + x
        g = acc / 3.0
        return {
            "interaction": torch.cat([g[: self.n_users][users], g[self.n_users :][items]], dim=-1),
            "visual": self.visual_proj(self.v_feat[items]),
            "text": self.text_proj(self.t_feat[items]),
        }

    def draws(self, generator, B: int) -> dict:
        d2 = 2 * self.embedding_dim
        return {"x0": torch.randn(B, d2, generator=generator, device=self.device),
                "t": torch.rand(B, 1, generator=generator, device=self.device),
                "keep": self.velocity_draws(generator, B)}

    def loss(self, state, batch, generator=None, draws=None):
        """``draws`` (``draws()``'s dict) replace the draws. Over a data axis
        (``batch["rows"]``) the draws (given or made) are the global
        batch's and this rank takes its rows; each term is this rank's
        rows' share of the global batch's."""
        users, pos, neg, w = batch["users"], batch["pos"], batch["neg"], batch["weight"]
        rows = batch.get("rows")
        B = users.shape[0] if rows is None else rows.n
        if draws is None:
            draws = self.draws(generator, B)
        if rows is not None:
            draws = rows.local(draws)
        conds = self.conditions(users, pos)
        X1 = torch.cat([self.user_embedding[users], self.item_embedding[pos]], dim=-1)
        X0, t = draws["x0"], draws["t"]
        X_t = t * X1 + (1 - t) * X0
        v_pred = self.velocity_of(X_t, t, conds, draws["keep"])
        rf = weighted_mean(((v_pred - (X1 - X0)) ** 2).mean(1), w, rows)
        u, p_e, n_e = self.user_embedding[users], self.item_embedding[pos], self.item_embedding[neg]
        bpr = weighted_mean(-F.logsigmoid((u * p_e).sum(1) - (u * n_e).sum(1)), w, rows)
        reg = self.reg_weight * ((u**2).sum() + (p_e**2).sum() + (n_e**2).sum()) / B
        total = self.lambda_rf * rf + self.lambda_rec * bpr + reg
        return total, (total,)

    @torch.no_grad()
    def generate(self, users, items, n_steps=None, start_noise=None, generator=None):
        """Euler-ODE generation of (user, item) embeddings for the pairs."""
        n_steps = n_steps or (1 if self.use_reflow else self.n_sampling_steps)
        conds = self.conditions(users, items)
        B = users.shape[0]
        z = start_noise
        if z is None:
            z = torch.randn(B, 2 * self.embedding_dim, generator=generator, device=self.device)
        dt = torch.tensor(1.0 / n_steps, dtype=torch.float32, device=self.device)
        steps = torch.arange(n_steps, dtype=torch.float32, device=self.device) * dt
        for i in range(n_steps):
            z = z + self.velocity_of(z, steps[i].expand(B, 1), conds) * dt
        return torch.chunk(z, 2, dim=-1)

    def full_embeddings(self, state):
        return self.user_embedding, self.item_embedding


# the reference's class name
RFMREC = RFMRec
