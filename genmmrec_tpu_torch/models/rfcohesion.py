"""RFCOHESION: COHESION + RF (counterpart of ``genmmrec_tpu/models/rfcohesion.py``):
the flow runs at COHESION's 3·64 width (id ⊕ visual ⊕ text); the
conditions are the raw features, built once."""

from __future__ import annotations

import torch

from genmmrec_tpu_torch.models.cohesion import COHESION
from genmmrec_tpu_torch.models.rf_host import RFHostMixin


class RFCOHESION(RFHostMixin, COHESION):
    RF_CONSTANT_CONDITIONS = True

    def __init__(self, config, data):
        super().__init__(config, data)
        self._rf_setup(3 * self.dim_latent, self.v_feat.shape[1] + self.t_feat.shape[1])

    def rf_host_repr(self, state):
        return torch.cat(self.forward(state))

    def rf_condition_feats(self):
        return [self.v_feat, self.t_feat]
