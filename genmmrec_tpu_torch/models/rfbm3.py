"""RFBM3: BM3 + RF (counterpart of ``genmmrec_tpu/models/rfbm3.py``): the
target is BM3's propagated (user ; item) representation, the conditions
its projected feature tables."""

from __future__ import annotations

import torch

from genmmrec_tpu_torch.models.bm3 import BM3
from genmmrec_tpu_torch.models.rf_host import RFHostMixin


class RFBM3(RFHostMixin, BM3):
    def __init__(self, config, data):
        super().__init__(config, data)
        self._rf_setup(self.embedding_dim, self.image_trs.out_features + self.text_trs.out_features)

    def rf_host_repr(self, state):
        return torch.cat(self.propagate())

    def rf_condition_feats(self):
        return [self.image_trs(self.image_embedding), self.text_trs(self.text_embedding)]
