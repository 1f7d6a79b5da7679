"""RFLightGCN_remove: LightGCN + an unconditional RF (ablation; counterpart of
``genmmrec_tpu/models/rflightgcn_remove.py``)."""

from __future__ import annotations

import torch

from genmmrec_tpu_torch.models.lightgcn import LightGCN
from genmmrec_tpu_torch.models.rf_host import RFHostMixin


class RFLightGCN_remove(RFHostMixin, LightGCN):
    RF_ZERO_CONDITION = True

    def __init__(self, config, data):
        super().__init__(config, data)
        self._rf_setup(self.latent_dim, 1)

    def rf_host_repr(self, state):
        return torch.cat(self.propagate())
