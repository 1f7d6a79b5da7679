"""DiffMM's multi-phase trainer (counterpart of
``genmmrec_tpu/engine/diffusion_trainers.py`` ``DiffMMTrainer``).

Each epoch runs, before the BPR/InfoNCE epoch of ``Trainer``:

1. ``_diffusion_epoch``: train the two per-modality denoisers, each with its
   own Adam, over dense per-user interaction vectors;
2. ``regenerate``: reverse-diffuse every user's interaction vector through
   each denoiser, take the top ``rebuild_k`` items (K3) and rebuild the two
   modal user-item graphs.

``_epoch_prelude`` runs both, in that order, from one generator.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from genmmrec_tpu_torch.engine.trainer import ChainOptimizer, Trainer, full_precision_matmuls
from genmmrec_tpu_torch.models.base import scalar
from genmmrec_tpu_torch.ops.topk import grouped_topk

MODALITIES = ("image", "text")


class DiffMMTrainer(Trainer):
    def _build_train_step(self, train_data) -> None:
        super()._build_train_step(train_data)
        self._build_diffusion_phase()

    def _build_diffusion_phase(self) -> None:
        """One plain Adam per denoiser, at the main learning rate."""
        lr = scalar(self.config["learning_rate"])
        groups = self.model.param_groups()
        for m in MODALITIES:
            self.optimizers[f"denoise_{m}"] = ChainOptimizer(groups[f"denoise_{m}"], "adam", lambda step: lr)

    @torch.enable_grad()
    def _diffusion_epoch(self, generator: Optional[torch.Generator] = None, plan: Optional[dict] = None):
        """Phase 1: one pass over the users in batches of ``train_batch_size``.

        The users are a permutation of ``U_pad = n_batches · B`` slots; slots
        past the last user are padding, weighted 0, and each batch's loss is
        the mean over its real users. The item embeddings and the modal
        features are computed once, detached. Returns the (n_batches, 2)
        per-batch (image, text) losses on the device.

        ``plan`` may give the slots (``users``, (n_batches, B)) and, per
        modality ``m``, the timesteps ``ts_m`` (n_batches, B), the noise
        ``noise_m`` and the dropout keep mask ``keep_m`` (n_batches, B,
        n_items), in place of the draws.
        """
        if "denoise_image" not in self.optimizers:
            self._build_diffusion_phase()
        full_precision_matmuls()
        model = self.model
        U, B = model.n_users, self.train_batch_size
        nb = -(-U // B)
        dev = model.device
        if plan is not None:
            batches = plan["users"].to(dev)
        else:
            batches = torch.randperm(nb * B, generator=generator, device=dev).reshape(nb, B)
        with torch.no_grad():
            i_embeds = model.iEmbeds.detach().clone()
            feats = {"image": model.get_image_feats(), "text": model.get_text_feats()}
        losses = []
        for b in range(nb):
            users = batches[b]
            valid = (users < U).to(torch.float32)
            x_start = model.interaction_vectors(users.clamp(max=U - 1)) * valid[:, None]
            denom = valid.sum().clamp(min=1.0)
            pair = []
            for m in MODALITIES:
                denoiser, opt = getattr(model, f"denoise_{m}"), self.optimizers[f"denoise_{m}"]
                drawn = {} if plan is None else {k: plan[f"{k}_{m}"][b].to(dev) for k in ("ts", "noise", "keep")}
                diff, gc = model.diffusion_losses(denoiser, x_start, i_embeds, feats[m], generator=generator, **drawn)
                loss = ((diff * valid).sum() + model.e_loss * (gc * valid).sum()) / denom
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
                opt.zero_grad(set_to_none=True)
                pair.append(loss.detach())
            losses.append(torch.stack(pair))
        return torch.stack(losses)

    @torch.no_grad()
    def regenerate(self, generator: Optional[torch.Generator] = None) -> dict:
        """Phase 2: rebuild ``self.state``'s modal graphs from the current
        denoisers.

        Users go in ``train_batch_size`` chunks; the last chunk is padded
        with the last user, so every chunk has the same shape, as in the
        JAX package. ``generator`` draws the edge dropout when
        ``keep_rate < 1`` and the sampling noise when it is on.
        """
        full_precision_matmuls()
        model = self.model
        U, B = model.n_users, self.train_batch_size
        n_chunks = -(-U // B)
        users = torch.arange(n_chunks * B, device=model.device).clamp_(max=U - 1)

        def topk_for(denoiser):
            idx = []
            for lo in range(0, n_chunks * B, B):
                x_start = model.interaction_vectors(users[lo : lo + B])
                denoised = model.p_sample_users(denoiser, x_start, generator)
                idx.append(grouped_topk(denoised, model.rebuild_k)[1])
            return torch.cat(idx)[:U]

        self.state = {
            **self.state,
            "image_ui": model.rebuild_ui_graph(topk_for(model.denoise_image), generator),
            "text_ui": model.rebuild_ui_graph(topk_for(model.denoise_text), generator),
        }
        return self.state

    def _epoch_prelude(self, generator: torch.Generator, epoch_idx: int) -> None:
        """Phase 1, then phase 2, timed apart: reading the losses ends
        phase 1 on the device, and a synchronize ends phase 2."""
        t0 = time.time()
        losses = self._diffusion_epoch(generator).sum(dim=0).cpu()
        t1 = time.time()
        self.regenerate(generator)
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)
        t2 = time.time()
        steps = -(-self.model.n_users // self.train_batch_size)
        self.prelude_log = {
            "diffusion_s": t1 - t0,
            "regenerate_s": t2 - t1,
            "diffusion_loss_image": float(losses[0]) / steps,
            "diffusion_loss_text": float(losses[1]) / steps,
        }
        self.logger.info(
            "Diffusion Loss: Image=%.4f, Text=%.4f [%.2fs]",
            self.prelude_log["diffusion_loss_image"], self.prelude_log["diffusion_loss_text"], t1 - t0,
        )
        self.logger.info("Regenerated UI graphs [%.2fs]", t2 - t1)
