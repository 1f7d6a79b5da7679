"""The multi-phase trainers of the generative models (counterpart of
``genmmrec_tpu/engine/diffusion_trainers.py``).

Each epoch runs two phases before the BPR epoch of ``Trainer``, in that
order, from one generator (``_epoch_prelude``, timed apart into
``prelude_log``):

1. ``_diffusion_epoch``: train the denoisers, each with its own Adam, over
   dense per-user interaction vectors;
2. ``regenerate``: rebuild the generated user-item graphs in
   ``self.state`` from the denoisers, in chunks of ``train_batch_size``
   users.

``DiffMMTrainer``: two per-modality denoisers; the regeneration takes each
user's top ``rebuild_k`` items of the reverse-diffused vector (K3).
``GenRecV1Trainer``: one flip-diffusion denoiser; the regeneration blends
the denoiser's sample into the original at its top ``gen_topk``
probabilities, filters the flips by the users' interest clusters
(``common.interest_cluster``, clustered once at construction when
``OpenInterestDebiase`` is on) and takes the top ``rebuild_k`` of the
blended probabilities (K3).
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from genmmrec_tpu_torch.common.interest_cluster import (
    DEFAULT_K,
    OPTIMAL_K,
    MultimodalCluster,
    build_debias_tables,
    interest_debias,
)
from genmmrec_tpu_torch.data.arrays import interaction_vectors
from genmmrec_tpu_torch.engine.trainer import ChainOptimizer, Trainer
from genmmrec_tpu_torch.models.base import scalar
from genmmrec_tpu_torch.ops.precision import full_precision_matmuls
from genmmrec_tpu_torch.ops.topk import grouped_topk

MODALITIES = ("image", "text")


class _DiffusionTrainer(Trainer):
    """Phase 1 and phase 2 before each BPR epoch. A subclass defines
    ``_build_diffusion_phase`` (one optimizer a denoiser, named as its
    parameter group), ``_phase1_inputs`` and ``_batch_losses`` (phase 1's
    per-batch losses on the device), ``_regenerated_graphs`` (phase 2) and
    ``_loss_log`` (the epoch's mean losses by name)."""

    def _build_train_step(self, train_data) -> None:
        super()._build_train_step(train_data)
        self._build_diffusion_phase()

    @torch.enable_grad()
    def _diffusion_epoch(self, generator: Optional[torch.Generator] = None, plan: Optional[dict] = None):
        """Phase 1: one pass over the users in batches of ``train_batch_size``.

        The users are a permutation of ``U_pad = n_batches · B`` slots; a
        slot past the last user is a zero row of ``x_start``, weighted 0 by
        ``valid``. ``_phase1_inputs`` (the item embeddings and modal
        features, detached) is computed once. Each batch steps the
        optimizer of each loss that ``_batch_losses`` yields, in turn.
        Returns the (n_batches, n_losses) per-batch losses on the device.
        ``plan`` may give the slots (``users``, (n_batches, B)) and the
        subclass's draws, in place of the draws.
        """
        if "denoise_image" not in self.optimizers:
            self._build_diffusion_phase()
        full_precision_matmuls()
        model = self.model
        U, B = model.n_users, self.train_batch_size
        nb = -(-U // B)
        if plan is not None:
            batches = plan["users"].to(model.device)
        else:
            batches = torch.randperm(nb * B, generator=generator, device=model.device).reshape(nb, B)
        with torch.no_grad():
            inputs = self._phase1_inputs()
        losses = []
        for b in range(nb):
            users = batches[b]
            valid = (users < U).to(torch.float32)
            x_start = interaction_vectors(model.data, users.clamp(max=U - 1)) * valid[:, None]
            step = []
            for name, loss in self._batch_losses(x_start, valid, inputs, generator, plan, b):
                opt = self.optimizers[name]
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
                opt.zero_grad(set_to_none=True)
                step.append(loss.detach())
            losses.append(torch.stack(step))
        return torch.stack(losses)

    def _user_chunks(self) -> list:
        """Phase 2's users in ``train_batch_size`` chunks; the last chunk
        is padded with the last user, so every chunk has the same shape, as
        in the JAX package."""
        U, B = self.model.n_users, self.train_batch_size
        n_chunks = -(-U // B)
        users = torch.arange(n_chunks * B, device=self.model.device).clamp_(max=U - 1)
        return [users[c * B : (c + 1) * B] for c in range(n_chunks)]

    def _top_items(self, chunk_topk) -> torch.Tensor:
        """(n_users, k) items: ``chunk_topk(c, users)`` over the chunks."""
        idx = [chunk_topk(c, users) for c, users in enumerate(self._user_chunks())]
        return torch.cat(idx)[: self.model.n_users]

    @torch.no_grad()
    def regenerate(self, generator: Optional[torch.Generator] = None, plan: Optional[dict] = None) -> dict:
        """Phase 2: rebuild ``self.state``'s generated graphs from the
        current denoisers. ``generator`` draws the edge dropout when
        ``keep_rate < 1`` and the sampling noise; ``plan`` may give the
        subclass's draws in their place."""
        full_precision_matmuls()
        self.state = {**self.state, **self._regenerated_graphs(generator, plan)}
        return self.state

    def _epoch_prelude(self, generator: torch.Generator, epoch_idx: int) -> None:
        """Phase 1, then phase 2, timed apart: reading the losses ends
        phase 1 on the device, and a synchronize ends phase 2."""
        t0 = time.time()
        losses = self._diffusion_epoch(generator).cpu()
        t1 = time.time()
        self.regenerate(generator)
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)
        t2 = time.time()
        self.prelude_log = {"diffusion_s": t1 - t0, "regenerate_s": t2 - t1, **self._loss_log(losses)}
        shown = ", ".join(f"{k}={v:.4f}" for k, v in self.prelude_log.items() if k.startswith("diffusion_loss"))
        self.logger.info("Diffusion Loss: %s [%.2fs]", shown, t1 - t0)
        self.logger.info("Regenerated UI graphs [%.2fs]", t2 - t1)


class DiffMMTrainer(_DiffusionTrainer):
    """Per batch, each modality's denoiser steps on the mean loss of the
    batch's real users. ``plan`` may give, per modality ``m``, the
    timesteps ``ts_m`` (n_batches, B), the noise ``noise_m`` and the
    dropout keep mask ``keep_m`` (n_batches, B, n_items); phase 2 takes
    no plan."""

    def _build_diffusion_phase(self) -> None:
        """One plain Adam per denoiser, at the main learning rate."""
        lr = scalar(self.config["learning_rate"])
        groups = self.model.param_groups()
        for m in MODALITIES:
            self.optimizers[f"denoise_{m}"] = ChainOptimizer(groups[f"denoise_{m}"], "adam", lambda step: lr)

    def _phase1_inputs(self) -> dict:
        model = self.model
        return {
            "i_embeds": model.iEmbeds.detach().clone(),
            "image": model.get_image_feats(),
            "text": model.get_text_feats(),
        }

    def _batch_losses(self, x_start, valid, inputs, generator, plan, b):
        model = self.model
        denom = valid.sum().clamp(min=1.0)
        for m in MODALITIES:
            drawn = {} if plan is None else {k: plan[f"{k}_{m}"][b].to(model.device) for k in ("ts", "noise", "keep")}
            denoiser = getattr(model, f"denoise_{m}")
            diff, gc = model.diffusion_losses(
                denoiser, x_start, inputs["i_embeds"], inputs[m], generator=generator, **drawn
            )
            yield f"denoise_{m}", ((diff * valid).sum() + model.e_loss * (gc * valid).sum()) / denom

    def _regenerated_graphs(self, generator, plan) -> dict:
        """Each modality's graph from each user's top ``rebuild_k`` items of
        the reverse-diffused vector (K3)."""
        if plan is not None:
            raise ValueError("DiffMM's phase 2 takes no plan")
        model = self.model

        def graph(denoiser):
            def chunk_topk(c, users):
                denoised = model.p_sample_users(denoiser, interaction_vectors(model.data, users), generator)
                return grouped_topk(denoised, model.rebuild_k)[1]

            return model.rebuild_ui_graph(self._top_items(chunk_topk), generator)

        return {"image_ui": graph(model.denoise_image), "text_ui": graph(model.denoise_text)}

    def _loss_log(self, losses) -> dict:
        steps = losses.shape[0]
        return {f"diffusion_loss_{m}": float(losses[:, j].sum()) / steps for j, m in enumerate(MODALITIES)}


class GenRecV1Trainer(_DiffusionTrainer):
    def __init__(self, config, model):
        super().__init__(config, model)
        self.sample_ratio = float(config["sample_ratio"] or 0.1)
        self.debias_tables = None
        self.cluster_s = 0.0
        if bool(config["OpenInterestDebiase"]):
            self._init_interest_clustering()

    def _init_interest_clustering(self) -> None:
        """Cluster the items' image and text features once (``OPTIMAL_K``
        of the dataset, else ``DEFAULT_K``) and build the debias tables;
        ``cluster_s`` keeps the wall time."""
        cfg, model = self.config, self.model
        t0 = time.time()
        cluster = MultimodalCluster(use_auto_optimal_k=bool(cfg["use_auto_optimal_k"]))
        ks = OPTIMAL_K.get(str(cfg["dataset"]), DEFAULT_K)
        self.logger.info("Performing Multimodal Clustering...")
        img = cluster.multimodal_specific_cluster(model.v_feat, ks.get("image", DEFAULT_K["image"]))
        txt = cluster.multimodal_specific_cluster(model.t_feat, ks.get("text", DEFAULT_K["text"]))
        # the tables' sizes are read back, which ends the clustering on the device
        self.debias_tables = build_debias_tables(model.data.users, model.data.items, model.n_users, img, txt)
        self.cluster_s = time.time() - t0
        self.logger.info("Multimodal Clustering Done [%.2fs].", self.cluster_s)

    def _build_diffusion_phase(self) -> None:
        """One plain Adam on the denoiser, at the main learning rate."""
        lr = scalar(self.config["learning_rate"])
        self.optimizers["denoise_image"] = ChainOptimizer(
            self.model.param_groups()["denoise_image"], "adam", lambda step: lr
        )

    def _phase1_inputs(self) -> dict:
        """The item embeddings and the modal features, without dropout."""
        model = self.model
        return {
            "i_embeds": model.item_id_embedding.detach().clone(),
            "image": model.get_image_feats(),
            "text": model.get_text_feats(),
        }

    def _batch_losses(self, x_start, valid, inputs, generator, plan, b):
        """The denoiser's loss over all B rows, padded ones included, as in
        the JAX package. ``plan`` may give, per batch, the draws of
        ``diffusion_losses`` (``draws``, a list of dicts)."""
        draws = None if plan is None else plan["draws"][b]
        model = self.model
        yield "denoise_image", model.diffusion_losses(
            x_start, inputs["i_embeds"], inputs["image"], inputs["text"], generator, draws
        )

    @torch.no_grad()
    def generate_chunk(self, users, generator=None, draws: Optional[dict] = None, sampled=None):
        """Phase 2 for one chunk of users: ``generate``, then the interest
        debias when the tables exist → (blended, probs), each (B, n_items).
        ``draws`` and ``sampled`` are ``generate``'s and
        ``interest_debias``'s draws."""
        model = self.model
        x_start = interaction_vectors(model.data, users)
        blended, probs = model.generate(x_start, generator, draws)
        if self.debias_tables is not None:
            blended = interest_debias(
                users, x_start, blended, self.debias_tables, self.sample_ratio, generator, sampled
            )
        return blended, probs

    def _regenerated_graphs(self, generator, plan) -> dict:
        """``image_ui`` from each user's top ``rebuild_k`` of blended · probs
        (K3). ``plan`` may give, per chunk, ``gen`` (``generate``'s draws)
        and ``sampled`` (the debias plane), and ``keep`` (the edge
        dropout's two masks), in place of the draws."""

        def chunk_topk(c, users):
            drawn = {} if plan is None else {"draws": plan["gen"][c], "sampled": plan["sampled"][c]}
            blended, probs = self.generate_chunk(users, generator, **drawn)
            return grouped_topk(blended * probs, self.model.rebuild_k)[1]

        keep = None if plan is None else plan["keep"]
        return {"image_ui": self.model.rebuild_ui_graph(self._top_items(chunk_topk), generator, keep)}

    def _loss_log(self, losses) -> dict:
        return {"diffusion_loss": float(losses.sum()) / losses.shape[0]}
