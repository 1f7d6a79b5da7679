"""RFFREEDOM: FREEDOM + RF (counterpart of ``genmmrec_tpu/models/rffreedom.py``):
the target propagates over the full normalized values; the conditions
are the projected features."""

from __future__ import annotations

import torch

from genmmrec_tpu_torch.models.freedom import FREEDOM
from genmmrec_tpu_torch.models.rf_host import RFHostMixin


class RFFREEDOM(RFHostMixin, FREEDOM):
    def __init__(self, config, data):
        super().__init__(config, data)
        self._rf_setup(self.embedding_dim, self.image_trs.out_features + self.text_trs.out_features)

    def rf_host_repr(self, state):
        return torch.cat(self.propagate(self.ui.values()))

    def rf_condition_feats(self):
        return [self.image_trs(self.v_feat), self.text_trs(self.t_feat)]
