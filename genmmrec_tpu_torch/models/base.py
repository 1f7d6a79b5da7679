"""Model base class (counterpart of ``genmmrec_tpu/models/base.py``).

A model is an ``nn.Module`` that holds its parameters; the per-epoch
artifacts (regenerated graphs) live in an explicit ``state`` dict that the
trainer passes in, as in the JAX package. Tensors the model builds go to
its training data's device. Randomness comes from ``torch.Generator``s the
trainer passes in.
"""

from __future__ import annotations

import torch
from torch import nn

from genmmrec_tpu_torch.data.arrays import TrainData
from genmmrec_tpu_torch.data.features import load_modal_features


EVAL_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
        # scoring type of the full-catalog evaluation. float32 is the
        # reference's. bfloat16 scores only feed the top-k, so it moves the
        # metrics through near-ties alone; with the base scores_cached the
        # trainer then takes the fused route (ops/fused_topk.py), which
        # writes no score plane, and otherwise hands K3 a bfloat16 plane.
        eval_dtype = str(config["eval_dtype"] or "float32")
        if eval_dtype not in EVAL_DTYPES:
            raise ValueError(f"eval_dtype must be one of {sorted(EVAL_DTYPES)}, not {eval_dtype!r}")
        self.eval_dtype = EVAL_DTYPES[eval_dtype]
        self.v_feat = self.t_feat = None
        if config["is_multimodal_model"] and self.is_multimodal:
            v, t = load_modal_features(config, self.n_items)
            if v is None and t is None:
                raise ValueError("Features all NONE")
            as_dev = lambda a: None if a is None else torch.as_tensor(a, device=self.device)
            self.v_feat, self.t_feat = as_dev(v), as_dev(t)

    @property
    def item_raw_features(self) -> torch.Tensor:
        """The raw item features, text then vision (VBPR's pattern), or
        whichever of the two the model has."""
        if self.v_feat is not None and self.t_feat is not None:
            return torch.cat([self.t_feat, self.v_feat], dim=-1)
        return self.v_feat if self.v_feat is not None else self.t_feat

    def describe(self) -> str:
        return f"{type(self).__name__}\nTrainable parameters: {sum(p.numel() for p in self.parameters())}"

    def init_state(self, generator=None) -> dict:
        return {}

    def param_groups(self) -> dict:
        """Parameters by optimizer: the main optimizer trains ``rec``; each
        label of ``label_transforms`` is the group of the submodule of that
        name. A model with parameters trained in phases of their own adds
        groups."""
        labels = self.label_transforms()
        groups = {"rec": [], **{label: [] for label in labels}}
        for name, p in self.named_parameters():
            top = name.split(".")[0]
            groups[top if top in labels else "rec"].append(p)
        return groups

    def label_transforms(self) -> dict:
        """label -> ``make(params)``, the optimizer of a group that the
        trainer steps after every batch beside the main one (the JAX
        package's ``label_transforms``); none by default."""
        return {}

    def loss(self, state, batch, generator=None):
        """(total loss, tuple of per-part losses) over a batch dict of
        ``users``/``pos``/``neg`` ids and a ``weight`` vector (0 on padding)."""
        raise NotImplementedError

    def loss_and_update(self, state, batch, generator=None, **draws):
        """Loss plus the per-batch state update; the default keeps the state.
        Gradients flow only through the loss. ``draws`` go to ``loss``."""
        total, parts = self.loss(state, batch, generator, **draws)
        return total, (parts, state)

    def pre_epoch(self, state, generator, epoch: int) -> dict:
        """Per-epoch state transform (e.g. edge dropout); identity by default."""
        return state

    def post_epoch(self, state):
        """Host-side hook after each epoch; may return a log string."""
        return None

    def scores(self, state, users) -> torch.Tensor:
        """(len(users), n_items) full-catalog scores of ``users``; the
        trainer calls it chunk by chunk for a model with no
        ``full_embeddings`` or ``eval_artifacts`` of its own."""
        raise NotImplementedError

    def full_embeddings(self, state):
        """(user, item) embedding matrices, computed once per evaluation."""
        raise NotImplementedError

    def eval_artifacts(self, state):
        return self.full_embeddings(state)

    def scores_cached(self, state, users, artifacts) -> torch.Tensor:
        """(len(users), n_items) scores ``u[users] @ iᵀ`` in ``eval_dtype``:
        bfloat16 takes bfloat16 operands, sums in float32 and rounds once."""
        u, i = artifacts
        if self.eval_dtype == torch.bfloat16:
            return u[users].bfloat16() @ i.bfloat16().T
        return u[users] @ i.T
