"""DiffGraph: graph diffusion over node embeddings (counterpart of
``genmmrec_tpu/models/diffgraph.py``).

- ``gcn_layer`` DGL-style passes over the unique user-item pairs in both
  directions: x scaled by the out-degree^-½, summed over the in-edges
  (``ops/mp.py`` ``propagate``, K1 on the card, the edge set mirrored so
  its backward runs on the same edges), scaled by the in-degree^-½ (both
  clamped at 1), leaky-ReLU 0.5; the layer sum of the row-normalized
  outputs plus the input. With one behaviour the target and the behaviour
  stacks are the same computation, done once here.
- Two ``Denoise`` MLPs (users, items) diffuse the behaviour embeddings
  toward the target ones: the SNR-weighted MSE over the full matrices with
  one timestep a node, read at the batch, and the one-step prediction
  added to the embeddings the BPR loss scores. Its draws (per side: the
  timesteps, the noise, the input dropout mask at rate 0.5) can be passed
  to ``loss``.
- ``full_embeddings``: the target embeddings plus the reverse chain of each
  denoiser from the behaviour ones.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from genmmrec_tpu_torch.common.init import xavier_uniform
from genmmrec_tpu_torch.common.losses import weighted_mean
from genmmrec_tpu_torch.common.norm import l2n
from genmmrec_tpu_torch.models.base import RecModel, scalar
from genmmrec_tpu_torch.models.diffusion.dnn import Denoise
from genmmrec_tpu_torch.models.diffusion.sampler import p_sample_loop
from genmmrec_tpu_torch.models.diffusion.schedule import make_schedule, q_sample, snr
from genmmrec_tpu_torch.ops.graph import unique_ui_pairs
from genmmrec_tpu_torch.ops.mp import degree, message_graph, propagate, sort_edges_by_dst

# the denoisers' input dropout in the diffusion loss
DIFF_DROPOUT = 0.5


class DiffGraph(RecModel):
    is_multimodal = False

    def __init__(self, config, data):
        super().__init__(config, data)
        self.latdim = scalar(config["embedding_size"], int)
        self.gcn_layer = scalar(config["gcn_layer"] or 2, int)
        self.steps = scalar(config["steps"], int)
        self.reg_weight = scalar(config["reg_weight"])
        self.sampling_steps = scalar(config["sampling_steps"] or 0, int)
        d_emb = scalar(config["d_emb_size"] or 10, int)
        norm = bool(config["norm"])
        N = self.n_users + self.n_items
        dev = self.device

        users, items = unique_ui_pairs(data.users.cpu().numpy(), data.items.cpu().numpy())
        items = items + self.n_users
        src, dst = sort_edges_by_dst(np.concatenate([users, items]), np.concatenate([items, users]))
        self.graph = message_graph(src, dst, N, dev, symmetric=True)
        src_t = torch.as_tensor(src, device=dev)
        dst_t = torch.as_tensor(dst, device=dev)
        self.out_scale = degree(src_t, N).clamp(min=1.0).pow(-0.5)[:, None]
        self.in_scale = degree(dst_t, N).clamp(min=1.0).pow(-0.5)[:, None]

        self.sched = make_schedule(
            "linear-var", scalar(config["noise_scale"]), scalar(config["noise_min"]), scalar(config["noise_max"]),
            self.steps, device=dev, beta_fixed_value=0.0001,
        )
        dims = config["dims"] if isinstance(config["dims"], list) else [config["dims"] or 1000]
        out_dims = list(dims) + [self.latdim]
        self.user_emb = nn.Parameter(torch.empty(self.n_users, self.latdim, device=dev))
        self.item_emb = nn.Parameter(torch.empty(self.n_items, self.latdim, device=dev))
        self.usr_denoiser = Denoise(out_dims[::-1], out_dims, d_emb, norm).to(dev)
        self.item_denoiser = Denoise(out_dims[::-1], out_dims, d_emb, norm).to(dev)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        self.user_emb.copy_(xavier_uniform(self.user_emb.shape, generator))
        self.item_emb.copy_(xavier_uniform(self.item_emb.shape, generator))
        self.usr_denoiser.init_params(generator)
        self.item_denoiser.init_params(generator)

    def _stack(self):
        x = torch.cat([self.user_emb, self.item_emb])
        acc, cur = x, x
        for _ in range(self.gcn_layer):
            cur = F.leaky_relu(propagate(cur * self.out_scale, self.graph, "add") * self.in_scale, 0.5)
            acc = acc + l2n(cur)
        return acc

    def forward(self):
        """(users, items) of the target stack, which is also the behaviour stack."""
        ui = self._stack()
        return ui[: self.n_users], ui[self.n_users :]

    def draws(self, generator):
        """Per side (users, items): timesteps, noise, input dropout mask."""
        out = []
        for n in (self.n_users, self.n_items):
            out.append((
                torch.randint(0, self.steps, (n,), generator=generator, device=self.device),
                torch.randn(n, self.latdim, generator=generator, device=self.device),
                torch.rand(n, self.latdim, generator=generator, device=self.device) < 1.0 - DIFF_DROPOUT,
            ))
        return tuple(out)

    def _diff_losses(self, dn, target, x_start, batch_idx, weights, ts, noise, keep, rows=None):
        x_t = q_sample(self.sched, x_start, ts, noise)
        out = dn(x_t, ts, dropout=DIFF_DROPOUT, keep=keep)
        mse = ((target - out) ** 2).mean(1)
        w = torch.where(ts == 0, 1.0, snr(self.sched, ts - 1) - snr(self.sched, ts))
        diff = (w * mse)[batch_idx]
        return weighted_mean(diff, weights, rows), out

    def loss(self, state, batch, generator=None, draws=None):
        """``draws`` (``draws()``'s two triples) replace the draws. Over a
        data axis (``batch["rows"]``) the diffusions, over whole tables,
        are the same on every rank, and each term is this rank's rows'
        share of the global batch's."""
        users, pos, neg, w = batch["users"], batch["pos"], batch["neg"], batch["weight"]
        rows = batch.get("rows")
        if draws is None:
            draws = self.draws(generator)
        usr, itm = self.forward()
        u_diff, diff_usr = self._diff_losses(self.usr_denoiser, usr, usr, users, w, *draws[0], rows)
        i_diff, diff_itm = self._diff_losses(self.item_denoiser, itm, itm, pos, w, *draws[1], rows)
        usr, itm = usr + diff_usr, itm + diff_itm
        anc, p_e, n_e = usr[users], itm[pos], itm[neg]
        bpr = weighted_mean(-torch.log(torch.sigmoid((anc * p_e).sum(1) - (anc * n_e).sum(1)) + 1e-12), w, rows)
        B = users.shape[0] if rows is None else rows.n
        reg = ((anc**2).sum() + (p_e**2).sum() + (n_e**2).sum()) * self.reg_weight / B
        total = bpr + reg + u_diff + i_diff
        return total, (total,)

    def full_embeddings(self, state):
        usr, itm = self.forward()
        gen = torch.Generator(device=usr.device).manual_seed(0) if self.sampling_steps > 0 else None
        denoised_u = p_sample_loop(self.sched, self.usr_denoiser, usr, self.sampling_steps, gen)
        denoised_i = p_sample_loop(self.sched, self.item_denoiser, itm, self.sampling_steps, gen)
        return usr + denoised_u, itm + denoised_i
