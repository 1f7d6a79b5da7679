"""SELFCF_{ed}: self-supervised CF with embedding dropout (counterpart of
``genmmrec_tpu/models/selfcfed_lgn.py``): a LightGCN encoder, detached
targets perturbed by dropout, a linear predictor, two halved negative-cosine
losses and an L2 regularizer. It trains without negatives
(``use_neg_sampling: False``); its scores add both online→target
directions, so its evaluation writes a score plane of its own in either
``eval_dtype`` and never takes the fused route."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from genmmrec_tpu_torch.common.encoders import LightGCNEncoder
from genmmrec_tpu_torch.common.init import init_linear, xavier_normal
from genmmrec_tpu_torch.common.losses import l2_loss, table_share, weighted_mean
from genmmrec_tpu_torch.models.base import RecModel, scalar


class SELFCFED_LGN(RecModel):
    is_multimodal = False

    def __init__(self, config, data):
        super().__init__(config, data)
        self.latent_size = scalar(config["embedding_size"], int)
        self.dropout = scalar(config["dropout"])
        self.reg_weight = scalar(config["reg_weight"])
        self.encoder = LightGCNEncoder(config, data)
        self.predictor = nn.Linear(self.latent_size, self.latent_size, device=self.device)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        self.encoder.init_params(generator)
        init_linear(self.predictor, generator, init=xavier_normal)

    def _drop(self, x, generator, keep):
        """Dropout of a detached target: kept entries scaled by 1/(1-p).
        ``keep`` is the bool mask, drawn from ``generator`` unless given."""
        if keep is None:
            keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - self.dropout
        return torch.where(keep, x / (1.0 - self.dropout), torch.zeros_like(x))

    def loss(self, state, batch, generator=None, keep=None):
        """``keep``: optional (user mask (n_users, d), item mask (n_items, d))
        in place of the two dropout draws. Over a data axis (``batch["rows"]``)
        the masks, over whole tables, are the same on every rank."""
        users, items, w = batch["users"], batch["pos"], batch["weight"]
        rows = batch.get("rows")
        keep_u, keep_i = keep if keep is not None else (None, None)
        u_online, i_online = self.encoder.propagate()
        u_target = self._drop(u_online.detach(), generator, keep_u)
        i_target = self._drop(i_online.detach(), generator, keep_i)
        reg = table_share(l2_loss(u_online, i_online), rows)
        u_on, i_on = self.predictor(u_online), self.predictor(i_online)

        def neg_cos(p, z):
            per = -(F.normalize(p, dim=-1, eps=1e-8) * F.normalize(z, dim=-1, eps=1e-8)).sum(-1)
            return weighted_mean(per, w, rows)

        loss_ui = neg_cos(u_on[users], i_target[items]) / 2
        loss_iu = neg_cos(i_on[items], u_target[users]) / 2
        total = loss_ui + loss_iu + self.reg_weight * reg
        return total, (total,)

    def eval_artifacts(self, state):
        u_online, i_online = self.encoder.propagate()
        return u_online, i_online, self.predictor(u_online), self.predictor(i_online)

    def scores_cached(self, state, users, artifacts) -> torch.Tensor:
        """Float32 scores whatever ``eval_dtype`` says, as in the reference."""
        u_online, i_online, u_on, i_on = artifacts
        return u_on[users] @ i_online.T + u_online[users] @ i_on.T
