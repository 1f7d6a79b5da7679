"""GenRecBM3: BM3 with the IPW causal denoiser and the RF generator
(counterpart of ``genmmrec_tpu/models/genrecbm3.py``).

The RF target is the denoised embedding (``CausalDenoiser``, over the
train interactions, BM3's ``n_layers`` layers); the loss stacks BM3's,
the RF losses and ``ps_loss_weight · ps_loss``, the denoiser run once a
batch (its output detached, its ``ps_loss`` with its graph). Evaluation:
BM3's propagation plus ``warmed · ratio · generate(...)`` (plain
``generate``, no 2-RF switch), then the predictor.
"""

from __future__ import annotations

import torch

from genmmrec_tpu_torch.common.losses import table_share
from genmmrec_tpu_torch.models import rf_modules as rf
from genmmrec_tpu_torch.models.base import scalar
from genmmrec_tpu_torch.models.bm3 import BM3
from genmmrec_tpu_torch.models.rf_host import RFHostMixin


class GenRecBM3(RFHostMixin, BM3):
    def __init__(self, config, data):
        super().__init__(config, data)
        self._rf_setup(self.embedding_dim, self.image_trs.out_features + self.text_trs.out_features)
        self.ps_loss_weight = scalar(config["ps_loss_weight"], default=0.1)
        users, items = data.users.cpu().numpy(), data.items.cpu().numpy()
        self.causal_denoiser = rf.CausalDenoiser(
            users, items, self.n_users, self.n_items, self.embedding_dim, self.n_layers, self.device
        )
        self._denoised = None

    def init_params(self, generator: torch.Generator) -> None:
        super().init_params(generator)
        self.causal_denoiser.init_params(generator)

    def rf_condition_feats(self):
        return [self.image_trs(self.image_embedding), self.text_trs(self.text_embedding)]

    def _ego(self) -> torch.Tensor:
        return torch.cat([self.user_embedding, self.item_id_embedding])

    def _denoise(self):
        return self.causal_denoiser(self._ego())

    def rf_host_repr(self, state):
        # inside ``loss`` the batch's denoiser output, run once there
        return self._denoised if self._denoised is not None else self._denoise()[0]

    def loss(self, state, batch, generator=None, rf_draws=None, keep=None):
        """Over a data axis (``batch["rows"]``) the denoiser's ``ps_loss``,
        over every train edge, is shared."""
        denoised, ps_loss = self._denoise()
        self._denoised = denoised
        try:
            total, _ = super().loss(state, batch, generator, rf_draws=rf_draws, keep=keep)
        finally:
            self._denoised = None
        total = total + self.ps_loss_weight * table_share(ps_loss, batch.get("rows"))
        return total, (total,)

    def full_embeddings(self, state, start_noise=None):
        if not self.use_rf:
            return BM3.full_embeddings(self, state)
        final = torch.cat(self.propagate())
        generated = rf.generate(self.rf, self._rf_conditions(), start_noise=self._rf_start_noise(start_noise))
        mixed = final + self._rf_warmed(state) * self.rf_cfg.inference_mix_ratio * generated
        return self.predictor(mixed[: self.n_users]), self.predictor(mixed[self.n_users :])
