"""The RF host mixin (counterpart of ``genmmrec_tpu/models/rf_host.py``).

The 15 RF variants share one pattern around a base model that the port
already has: a ``VelocityNet`` (``rf``, trained by its own AdamW, the
``"rf"`` group of ``label_transforms``) learns to generate the host's final
user + item representation (``rf_host_repr``, taken without an autograd
graph) from conditions: item feature matrices (``rf_condition_feats``),
each lifted to the users by the raw interaction matrix R (unit values,
rows stably sorted by user, duplicates kept; K1) and stacked over the
items. The RF losses (flow, then InfoNCE) join the host's parts. At
evaluation the scoring embeddings are ``final + warmed · ratio ·
generate(...)``, from a start noise drawn by a generator seeded 0;
``warmed`` is 1 from ``rf_warmup_epochs`` on, and before it the generated
term is still computed, then multiplied by 0.

``rf_epoch`` rides in the state as a Python int. A host whose conditions do
not depend on its parameters (raw features: ``RF_CONSTANT_CONDITIONS``; a
zero column: ``RF_ZERO_CONDITION``, the ablations) builds them once at
set-up.

A host calls ``_rf_setup(embedding_dim, condition_dim)`` at the end of its
constructor. ``loss`` takes the host's own draws as keyword arguments and
the RF draws as ``rf_draws`` (``rf_modules.rf_draws``'s dict);
``full_embeddings`` takes the start noise as ``start_noise`` and, with
``use_rf`` false, the host's own evaluation draws as keyword arguments.
"""

from __future__ import annotations

from typing import List

import torch

from genmmrec_tpu_torch.engine.trainer import adamw
from genmmrec_tpu_torch.models import rf_modules as rf
from genmmrec_tpu_torch.ops.graph import interaction_matrix, spmm


class RFHostMixin:
    RF_CONSTANT_CONDITIONS = False
    RF_ZERO_CONDITION = False

    def _rf_setup(self, embedding_dim: int, condition_dim: int) -> None:
        config = self.config
        self.use_rf = True if config["use_rf"] is None else bool(config["use_rf"])
        self.rf_cfg = rf.RFConfig.from_config(config, self.n_users, self.n_items, embedding_dim)
        users, items = self.data.users.cpu().numpy(), self.data.items.cpu().numpy()
        self._rf_R = interaction_matrix(users, items, self.n_users, self.n_items, self.device)
        if self.use_rf:
            self.rf = rf.VelocityNet(self.rf_cfg, condition_dim, self.device)
        self._rf_cached = None
        if self.RF_ZERO_CONDITION:
            self._rf_cached = torch.zeros(self.n_users + self.n_items, 1, device=self.device)
        elif self.RF_CONSTANT_CONDITIONS:
            self._rf_cached = self._rf_conditions()

    # -- hooks ----------------------------------------------------------
    def rf_host_repr(self, state) -> torch.Tensor:
        """(n_users + n_items, d) final host representation."""
        raise NotImplementedError

    def rf_condition_feats(self) -> List[torch.Tensor]:
        """Item-level feature matrices used as conditions (each (I, d_c))."""
        raise NotImplementedError

    # -- framework overrides -------------------------------------------
    def init_params(self, generator: torch.Generator) -> None:
        super().init_params(generator)
        if self.use_rf:
            self.rf.init_params(generator)

    def label_transforms(self) -> dict:
        if not self.use_rf:
            return {}
        return {"rf": lambda params: adamw(params, self.rf_cfg.learning_rate)}

    def init_state(self, generator=None) -> dict:
        return {**(super().init_state(generator) or {}), "rf_epoch": 0}

    def pre_epoch(self, state, generator, epoch: int, **kw) -> dict:
        host = {k: v for k, v in state.items() if k != "rf_epoch"}
        return {**(super().pre_epoch(host, generator, epoch, **kw) or {}), "rf_epoch": int(epoch)}

    @torch.no_grad()
    def _rf_conditions(self) -> torch.Tensor:
        """(n_users + n_items, Σ d_c): each feature matrix lifted to the
        users by R, over the items, concatenated."""
        if self._rf_cached is not None:
            return self._rf_cached
        feats = self.rf_condition_feats()
        return torch.cat([torch.cat([spmm(self._rf_R, f), f]) for f in feats], dim=-1)

    def rf_draws(self, generator, batch_size: int, epoch: int) -> dict:
        return rf.rf_draws(self.rf_cfg, generator, self.n_users + self.n_items, batch_size, self.device, epoch)

    def loss(self, state, batch, generator=None, rf_draws=None, **host_draws):
        """Over a data axis (``batch["rows"]``) the host's loss splits as its
        own does, and the RF draws (given or made) are the global batch's:
        ``rf_losses`` takes this rank's rows of the negatives."""
        total, parts = super().loss(state, batch, generator, **host_draws)
        if not self.use_rf:
            return total, parts
        with torch.no_grad():
            target = self.rf_host_repr(state)
        conditions = self._rf_conditions()
        epoch = state["rf_epoch"]
        rows = batch.get("rows")
        if rf_draws is None:
            rf_draws = self.rf_draws(generator, batch["users"].shape[0] if rows is None else rows.n, epoch)
        rf_total, rf_flow, rf_cl = rf.rf_losses_staged(
            self.rf, epoch, target, conditions, None, batch["users"], batch["pos"], batch["weight"], rf_draws,
            rows=rows,
        )
        return total + rf_total, tuple(parts) + (rf_flow, rf_cl)

    def _rf_start_noise(self, start_noise=None) -> torch.Tensor:
        return rf.seeded_start_noise(self.rf_cfg, self.n_users + self.n_items, self.device, start_noise)

    def _rf_warmed(self, state) -> float:
        return float(state["rf_epoch"] >= self.rf_cfg.warmup_epochs)

    def full_embeddings(self, state, start_noise=None, **host_draws):
        """With ``use_rf`` false the host's own evaluation, which takes
        ``host_draws`` (LGMRec's ``draws``); otherwise the mix."""
        if not self.use_rf:
            return super().full_embeddings(state, **host_draws)
        final = self.rf_host_repr(state)
        generated = rf.generate_staged(self.rf, self._rf_conditions(), state["rf_epoch"],
                                       start_noise=self._rf_start_noise(start_noise))
        mixed = final + self._rf_warmed(state) * self.rf_cfg.inference_mix_ratio * generated
        return mixed[: self.n_users], mixed[self.n_users :]
