"""RFLGMRec: LGMRec + RF (counterpart of ``genmmrec_tpu/models/rflgmrec.py``):
the target is LGMRec's forward with the draws of a generator seeded 0 (the
draws of its evaluation), made once and kept; the conditions are the
features through the (in, out) projections ``item_image_trs`` /
``item_text_trs``."""

from __future__ import annotations

import torch

from genmmrec_tpu_torch.models.lgmrec import LGMRec
from genmmrec_tpu_torch.models.rf_host import RFHostMixin


class RFLGMRec(RFHostMixin, LGMRec):
    def __init__(self, config, data):
        super().__init__(config, data)
        self._rf_setup(self.embedding_dim, self.item_image_trs.shape[1] + self.item_text_trs.shape[1])
        self.repr_draws = self.draws(torch.Generator(device=self.device).manual_seed(0))

    def rf_host_repr(self, state):
        u, i, _ = self.forward(self.repr_draws)
        return torch.cat([u, i])

    def rf_condition_feats(self):
        return [self.v_feat @ self.item_image_trs, self.t_feat @ self.item_text_trs]
