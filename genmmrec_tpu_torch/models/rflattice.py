"""RFLATTICE: LATTICE + RF (counterpart of ``genmmrec_tpu/models/rflattice.py``);
the target's propagation takes the learned graph's per-step top-k (K3)."""

from __future__ import annotations

import torch

from genmmrec_tpu_torch.models.lattice import LATTICE
from genmmrec_tpu_torch.models.rf_host import RFHostMixin


class RFLATTICE(RFHostMixin, LATTICE):
    def __init__(self, config, data):
        super().__init__(config, data)
        self._rf_setup(self.embedding_dim, self.image_trs.out_features + self.text_trs.out_features)

    def rf_host_repr(self, state):
        return torch.cat(self.propagate())

    def rf_condition_feats(self):
        return [self.image_trs(self.v_feat), self.text_trs(self.t_feat)]
