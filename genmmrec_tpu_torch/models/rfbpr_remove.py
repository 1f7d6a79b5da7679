"""RFBPR_remove: BPR + an unconditional RF (ablation; counterpart of
``genmmrec_tpu/models/rfbpr_remove.py``): the condition is one zero column,
built once."""

from __future__ import annotations

import torch

from genmmrec_tpu_torch.models.bpr import BPR
from genmmrec_tpu_torch.models.rf_host import RFHostMixin


class RFBPR_remove(RFHostMixin, BPR):
    RF_ZERO_CONDITION = True

    def __init__(self, config, data):
        super().__init__(config, data)
        self._rf_setup(self.embedding_size, 1)

    def rf_host_repr(self, state):
        return torch.cat([self.user_emb, self.item_emb])
