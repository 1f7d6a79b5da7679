"""Model base class (counterpart of ``genmmrec_tpu/models/base.py``).

A model is an ``nn.Module`` that holds its parameters; the per-epoch
artifacts (regenerated graphs) live in an explicit ``state`` dict that the
trainer passes in, as in the JAX package. Tensors the model builds go to
its training data's device.
"""

from __future__ import annotations

import torch
from torch import nn

from genmmrec_tpu_torch.data.arrays import TrainData
from genmmrec_tpu_torch.data.features import load_modal_features


def scalar(value, cast=float, default=None):
    """A config value that may still be a hyper-grid list takes its first
    entry; ``default`` applies only when the value is absent."""
    if isinstance(value, list):
        value = value[0]
    if value is None and default is not None:
        value = default
    return cast(value)


class RecModel(nn.Module):
    is_multimodal = True

    def __init__(self, config, data: TrainData):
        super().__init__()
        self.config = config
        self.data = data
        self.device = data.device
        self.n_users = data.n_users
        self.n_items = data.n_items
        eval_dtype = str(config["eval_dtype"] or "float32")
        if eval_dtype != "float32":
            # the bf16 scoring path goes with the fused score+mask+top-k kernel
            raise NotImplementedError(f"eval_dtype {eval_dtype} is not ported yet")
        self.v_feat = self.t_feat = None
        if config["is_multimodal_model"] and self.is_multimodal:
            v, t = load_modal_features(config, self.n_items)
            if v is None and t is None:
                raise ValueError("Features all NONE")
            as_dev = lambda a: None if a is None else torch.as_tensor(a, device=self.device)
            self.v_feat, self.t_feat = as_dev(v), as_dev(t)

    def init_state(self, generator=None) -> dict:
        return {}

    def full_embeddings(self, state):
        """(user, item) embedding matrices, computed once per evaluation."""
        raise NotImplementedError

    def eval_artifacts(self, state):
        return self.full_embeddings(state)

    def scores_cached(self, state, users, artifacts) -> torch.Tensor:
        """(len(users), n_items) float32 scores ``u[users] @ iᵀ``."""
        u, i = artifacts
        return u[users] @ i.T
