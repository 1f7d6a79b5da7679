"""RFGUMETime: RFGUME with a temporal source (counterpart of
``genmmrec_tpu/models/rfgumetime.py``).

- The interactions up to the ``1 − temporal_ratio`` quantile of their
  times (``TrainData.times``, float32, the quantile in float64; file order
  when there are none) form a historical user-item graph, normalized with
  GUME's common KNN item pairs as the full graph is (an empty split keeps
  every edge).
- The flow runs from ``X0 = conv(historical graph)`` (detached) to the
  target, in the loss and as the start of ``generate``; with
  ``temporal_ratio`` 0 it is RFGUME.
- Evaluation mixes convexly: ``(1 − r)·original + r·generated``, ``r =
  warmed · ratio``.
"""

from __future__ import annotations

import numpy as np
import torch

from genmmrec_tpu_torch.models.base import scalar
from genmmrec_tpu_torch.models.gume import augmented_adj
from genmmrec_tpu_torch.models.rfgume import RFGUME
from genmmrec_tpu_torch.ops.graph import layer_mean


class RFGUMETime(RFGUME):
    def __init__(self, config, data):
        super().__init__(config, data)
        self.temporal_ratio = scalar(config["temporal_ratio"] or 0.0)
        self.historical_adj = None
        if self.temporal_ratio > 0:
            users, items = data.users.cpu().numpy(), data.items.cpu().numpy()
            if data.times is not None:
                times = data.times.cpu().numpy().astype(np.float64)
            else:
                times = np.arange(len(users), dtype=np.float64)
            cutoff = np.quantile(times, 1.0 - self.temporal_ratio)
            hist = times <= cutoff
            if hist.sum() == 0:
                hist[:] = True
            as_dev = lambda a: torch.as_tensor(a[hist], dtype=torch.int64, device=self.device)
            self.historical_adj, _ = augmented_adj(
                as_dev(users), as_dev(items), self.ii_rows, self.ii_cols, self.n_users, self.n_items
            )

    def _rf_x0(self):
        if self.historical_adj is None:
            return None
        return layer_mean(self.historical_adj, self._ego(), self.n_ui_layers)

    def _mix_eval(self, original, generated, warmed: float):
        r = warmed * self.rf_cfg.inference_mix_ratio
        return (1.0 - r) * original + r * generated
