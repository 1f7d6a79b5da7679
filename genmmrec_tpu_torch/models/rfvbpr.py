"""RFVBPR: VBPR + RF (counterpart of ``genmmrec_tpu/models/rfvbpr.py``): the
flow runs at VBPR's 2·d width (id ⊕ modal projection); the condition is
the raw item features (text then vision), built once."""

from __future__ import annotations

import torch

from genmmrec_tpu_torch.models.vbpr import VBPR
from genmmrec_tpu_torch.models.rf_host import RFHostMixin


class RFVBPR(RFHostMixin, VBPR):
    RF_CONSTANT_CONDITIONS = True

    def __init__(self, config, data):
        super().__init__(config, data)
        self._rf_setup(2 * self.embedding_size, self.raw_features.shape[1])

    def rf_host_repr(self, state):
        return torch.cat([self.u_embedding, self._item_embeddings()])

    def rf_condition_feats(self):
        return [self.raw_features]
