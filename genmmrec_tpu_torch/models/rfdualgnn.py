"""RFDualGNN: DualGNN + RF (counterpart of ``genmmrec_tpu/models/rfdualgnn.py``);
the conditions are the raw features, built once."""

from __future__ import annotations

from genmmrec_tpu_torch.models.dualgnn import DualGNN
from genmmrec_tpu_torch.models.rf_host import RFHostMixin


class RFDualGNN(RFHostMixin, DualGNN):
    RF_CONSTANT_CONDITIONS = True

    def __init__(self, config, data):
        super().__init__(config, data)
        self._rf_setup(self.dim_latent, self.v_feat.shape[1] + self.t_feat.shape[1])

    def rf_host_repr(self, state):
        return self.forward()

    def rf_condition_feats(self):
        return [self.v_feat, self.t_feat]
