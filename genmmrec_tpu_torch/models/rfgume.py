"""RFGUME: GUME with the Rectified-Flow generator (counterpart of
``genmmrec_tpu/models/rfgume.py``).

- The flow learns GUME's extended id embeddings (with ``use_denoise``, the
  causal denoiser's output over the train interactions) from the explicit
  modal embeddings ``[image, text]``, which the loss takes from GUME's own
  ``forward(train=True)``, detached; its user prior is ``Z_u − mean(Z_u)``
  (``Z_u`` the users' explicit image + text), the items' prior zero.
- The loss: GUME's, the RF losses and, with ``use_denoise``,
  ``ps_loss_weight · ps_loss``; it reports the total alone.
- Evaluation: ``extended_id = _mix_eval(original, generated, warmed)``,
  ``original + warmed · ratio · generated``, through GUME's forward; the
  start noise ``_rf_x0`` (None: normals from a generator seeded 0).

``epoch`` rides in the state as a Python int; ``rf`` steps with its own
AdamW (``label_transforms``).
"""

from __future__ import annotations

import torch

from genmmrec_tpu_torch.common.losses import table_share
from genmmrec_tpu_torch.engine.trainer import adamw
from genmmrec_tpu_torch.models import rf_modules as rf
from genmmrec_tpu_torch.models.base import scalar
from genmmrec_tpu_torch.models.gume import GUME
from genmmrec_tpu_torch.ops.graph import layer_mean


class RFGUME(GUME):
    def __init__(self, config, data):
        super().__init__(config, data)
        self.use_rf = True if config["use_rf"] is None else bool(config["use_rf"])
        d = self.embedding_dim
        self.rf_cfg = rf.RFConfig.from_config(config, self.n_users, self.n_items, d)
        self.use_denoise = bool(config["use_denoise"])
        self.ps_loss_weight = scalar(config["ps_loss_weight"] or 0.1)
        if self.use_rf:
            self.rf = rf.VelocityNet(self.rf_cfg, 2 * d, self.device)
        if self.use_denoise:
            users, items = data.users.cpu().numpy(), data.items.cpu().numpy()
            self.causal_denoiser = rf.CausalDenoiser(users, items, self.n_users, self.n_items, d, 2, self.device)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        super().init_params(generator)
        if self.use_rf:
            self.rf.init_params(generator)
        if self.use_denoise:
            self.causal_denoiser.init_params(generator)

    def label_transforms(self) -> dict:
        if not self.use_rf:
            return {}
        return {"rf": lambda params: adamw(params, self.rf_cfg.learning_rate)}

    def init_state(self, generator=None) -> dict:
        return {"epoch": 0}

    def pre_epoch(self, state, generator, epoch: int) -> dict:
        return {**state, "epoch": int(epoch)}

    # ------------------------------------------------------------------
    def _ego(self) -> torch.Tensor:
        return torch.cat([self.user_embedding, self.item_id_embedding])

    def _rf_x0(self):
        """The flow's source: None, Gaussian noise (RFGUMETime's differs)."""
        return None

    def _mix_eval(self, original, generated, warmed: float):
        """The evaluation's mix: the additive residual."""
        return original + warmed * self.rf_cfg.inference_mix_ratio * generated

    def rf_draws(self, generator, batch_size: int, epoch: int) -> dict:
        return rf.rf_draws(self.rf_cfg, generator, self.n_users + self.n_items, batch_size, self.device, epoch)

    def loss(self, state, batch, generator=None, noise=None, rf_draws=None):
        """Over a data axis (``batch["rows"]``) GUME's loss splits as its own
        does, the RF draws (given or made) are the global batch's, and the
        denoiser's ``ps_loss``, over every train edge, is shared."""
        out = self.forward(train=True)
        total, _ = self.loss_of(out, batch, generator, noise)
        if not self.use_rf:
            return total, (total,)
        explicit_image, explicit_text = (e.detach() for e in out[2])
        conditions = torch.cat([explicit_image, explicit_text], dim=-1)
        if self.use_denoise:
            target, ps_loss = self.causal_denoiser(self._ego())
        else:
            with torch.no_grad():
                target = layer_mean(self.norm_adj, self._ego(), self.n_ui_layers)
        nu = self.n_users
        z_u = explicit_image[:nu] + explicit_text[:nu]
        prior = torch.cat([z_u - z_u.mean(dim=0, keepdim=True), torch.zeros_like(explicit_image[nu:])])
        with torch.no_grad():
            x0 = self._rf_x0()
        epoch = state["epoch"]
        rows = batch.get("rows")
        if rf_draws is None:
            rf_draws = self.rf_draws(generator, batch["users"].shape[0] if rows is None else rows.n, epoch)
        rf_total, _, _ = rf.rf_losses_staged(
            self.rf, epoch, target, conditions, prior, batch["users"], batch["pos"], batch["weight"], rf_draws,
            fixed_noise=x0, rows=rows,
        )
        total = total + rf_total
        if self.use_denoise:
            total = total + self.ps_loss_weight * table_share(ps_loss, rows)
        return total, (total,)

    def full_embeddings(self, state, start_noise=None):
        if not self.use_rf:
            return super().full_embeddings(state)
        _, _, explicit_image, explicit_text = self.explicit_embeds()
        conditions = torch.cat([explicit_image, explicit_text], dim=-1)
        x0 = self._rf_x0()
        if x0 is None:
            x0 = rf.seeded_start_noise(self.rf_cfg, self.n_users + self.n_items, self.device, start_noise)
        generated = rf.generate_staged(self.rf, conditions, state["epoch"], start_noise=x0)
        original = layer_mean(self.norm_adj, self._ego(), self.n_ui_layers)
        warmed = float(state["epoch"] >= self.rf_cfg.warmup_epochs)
        all_e = self.forward(extended_id_override=self._mix_eval(original, generated, warmed))
        return all_e[: self.n_users], all_e[self.n_users :]
