"""RFPGL: PGL + RF (counterpart of ``genmmrec_tpu/models/rfpgl.py``): the flow
runs at PGL's 2·feat_embed_dim width over the full graph's values; the
conditions are the raw features, built once."""

from __future__ import annotations

import torch

from genmmrec_tpu_torch.models.pgl import PGL
from genmmrec_tpu_torch.models.rf_host import RFHostMixin


class RFPGL(RFHostMixin, PGL):
    RF_CONSTANT_CONDITIONS = True

    def __init__(self, config, data):
        super().__init__(config, data)
        self._rf_setup(2 * self.feat_embed_dim, self.v_feat.shape[1] + self.t_feat.shape[1])

    def rf_host_repr(self, state):
        return torch.cat(self.forward(self.ui.graph(self.ui.values())))

    def rf_condition_feats(self):
        return [self.v_feat, self.t_feat]
