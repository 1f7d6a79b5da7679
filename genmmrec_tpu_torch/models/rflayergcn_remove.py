"""RFLayerGCN_remove: LayerGCN + an unconditional RF (ablation; counterpart of
``genmmrec_tpu/models/rflayergcn_remove.py``); the target propagates over
the epoch's pruned values."""

from __future__ import annotations

import torch

from genmmrec_tpu_torch.models.layergcn import LayerGCN
from genmmrec_tpu_torch.models.rf_host import RFHostMixin


class RFLayerGCN_remove(RFHostMixin, LayerGCN):
    RF_ZERO_CONDITION = True

    def __init__(self, config, data):
        super().__init__(config, data)
        self._rf_setup(self.latent_dim, 1)

    def rf_host_repr(self, state):
        return torch.cat(self.propagate(state["masked_vals"]))
