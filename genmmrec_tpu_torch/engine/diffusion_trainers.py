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

``MVDiffTrainer`` runs four phases of its own before the BPR epoch: the
feature denoisers' epoch over the items, the item-item graphs' rebuild,
the sparsity denoisers' epoch over the users and the user-item graphs'
rebuild (K3 for every top-k).

On a data axis phase 1's batches (MVDiff's phases 1 and 3) split over the
ranks as the BPR batches do, and phase 2 (MVDiff's phase 4) deals its user
chunks whole, chunk ``i`` to data rank ``i % data`` (``dealt_chunks``);
every rank still makes every chunk's draws, in the order one rank makes
them, so that the generator stays in step with the one-device run, and the
chunks' top items are gathered.

On a model axis the denoisers and every (B, n_items) vector of phases 1
and 2 (MVDiff's phases 3 and 4) split over the items (``split_items``,
``parallel.mesh.ItemCols``): each rank builds only its columns of the
interaction vectors, takes its columns of each draw made whole (the
models' draw functions, and ``pm.item_planes`` for draws handed in whole
by a plan), runs the denoisers on them and takes each top-k of the
regeneration by K3 on its columns, merged over the axis
(``ItemCols.topk``). The data axis deals its chunks whole as before.
The tables held as each rank's rows (``Trainer._place_params``) are read
whole inside ``pm.whole_tables``: once a batch of phase 1 (and of MVDiff's
phases 1 and 3), once for each phase's inputs and once a regeneration.
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
from genmmrec_tpu_torch.common.losses import weighted_mean
from genmmrec_tpu_torch.data.arrays import interaction_vectors
from genmmrec_tpu_torch.engine.trainer import ChainOptimizer, Trainer
from genmmrec_tpu_torch.models.base import scalar
from genmmrec_tpu_torch.ops.precision import full_precision_matmuls
from genmmrec_tpu_torch.parallel import mesh as pm
from genmmrec_tpu_torch.ops.topk import grouped_topk

MODALITIES = ("image", "text")


def split_items(trainer) -> Optional[pm.ItemCols]:
    """On a model axis, put ``trainer.model``'s denoisers on the item split
    (once; ``model.split_items``); returns ``model.item_cols``, None off a
    model axis."""
    model = trainer.model
    cols = pm.item_sharding(trainer.mesh, model.n_items)
    if cols is not None and model.item_cols is None:
        model.split_items(cols)
    return model.item_cols


def dealt_chunks(mesh, chunks: list, chunk_topk, width: int, chunk_draws=None) -> torch.Tensor:
    """(Σ rows of the chunks, width) int64: ``chunk_topk(c, users)`` over
    the chunks of users, in chunk order. On a data axis each rank takes its
    dealt chunks (``pm.deal``), with the draws ``chunk_draws(n_rows)`` makes
    for every chunk in turn (so that the generator stays in step with one
    rank's), and the chunks' rows are gathered: every rank then holds every
    chunk's."""
    if pm.axis_size(mesh, pm.DATA_AXIS) == 1:
        return torch.cat([chunk_topk(c, users) for c, users in enumerate(chunks)])
    mine, dealt = [], set(pm.deal(len(chunks), mesh))
    for c, users in enumerate(chunks):
        drawn = chunk_draws(users.shape[0]) if chunk_draws is not None else {}
        if c in dealt:
            mine.append(chunk_topk(c, users, **drawn))
    like = torch.empty(chunks[0].shape[0], width, dtype=torch.int64, device=chunks[0].device)
    return pm.gather_chunks(mine, len(chunks), mesh, like).reshape(-1, width)


class _DiffusionTrainer(Trainer):
    """Phase 1 and phase 2 before each BPR epoch. A subclass defines
    ``_build_diffusion_phase`` (one optimizer a denoiser, named as its
    parameter group), ``_phase1_inputs`` and ``_batch_losses`` (phase 1's
    per-batch losses on the device), ``_regenerated_graphs`` (phase 2) and
    ``_loss_log`` (the epoch's mean losses by name)."""

    def _build_train_step(self, train_data) -> None:
        super()._build_train_step(train_data)
        split_items(self)
        self._build_diffusion_phase()

    def _split_items(self) -> None:
        split_items(self)

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
        subclass's draws, in place of the draws. On a data axis each rank
        takes its rows of every batch (a plan's draws are the global
        batch's) and the losses returned are the global batch's.
        """
        if "denoise_image" not in self.optimizers:
            split_items(self)
            self._build_diffusion_phase()
        full_precision_matmuls()
        model = self.model
        cols = model.item_cols
        U, B = model.n_users, self.train_batch_size
        nb = -(-U // B)
        if plan is not None:
            batches = plan["users"].to(model.device)
        else:
            batches = torch.randperm(nb * B, generator=generator, device=model.device).reshape(nb, B)
        with torch.no_grad(), pm.whole_tables(model):
            inputs = self._phase1_inputs()
        rows = pm.data_sharding(self.mesh, B)
        losses = []
        for b in range(nb):
            users = batches[b] if rows is None else rows.local(batches[b])
            valid = (users < U).to(torch.float32)
            x_start = interaction_vectors(model.data, users.clamp(max=U - 1), cols) * valid[:, None]
            step = []
            # each loss reads its own denoiser alone, so the steps of the
            # ones before it leave its gathered tables current
            with pm.whole_tables(model):
                for name, loss in self._batch_losses(x_start, valid, inputs, generator, plan, b, rows):
                    opt = self.optimizers[name]
                    opt.zero_grad(set_to_none=True)
                    loss.backward()
                    if rows is not None:
                        pm.reduce_grads(self._step_params([name]), self.mesh)
                    opt.step()
                    opt.zero_grad(set_to_none=True)
                    step.append(loss.detach())
            losses.append(torch.stack(step))
        losses = torch.stack(losses)
        return losses if rows is None else pm.all_reduce(losses, self.mesh, pm.DATA_AXIS)

    def _user_chunks(self) -> list:
        """Phase 2's users in ``train_batch_size`` chunks; the last chunk
        is padded with the last user, so every chunk has the same shape, as
        in the JAX package."""
        U, B = self.model.n_users, self.train_batch_size
        n_chunks = -(-U // B)
        users = torch.arange(n_chunks * B, device=self.model.device).clamp_(max=U - 1)
        return [users[c * B : (c + 1) * B] for c in range(n_chunks)]

    def _top_items(self, chunk_topk, chunk_draws=None) -> torch.Tensor:
        """(n_users, k) items: ``chunk_topk(c, users)`` over the chunks
        (``dealt_chunks``)."""
        top = dealt_chunks(self.mesh, self._user_chunks(), chunk_topk, self.model.rebuild_k, chunk_draws)
        return top[: self.model.n_users]

    @torch.no_grad()
    def regenerate(self, generator: Optional[torch.Generator] = None, plan: Optional[dict] = None) -> dict:
        """Phase 2: rebuild ``self.state``'s generated graphs from the
        current denoisers. ``generator`` draws the edge dropout when
        ``keep_rate < 1`` and the sampling noise; ``plan`` may give the
        subclass's draws in their place."""
        full_precision_matmuls()
        split_items(self)
        with pm.whole_tables(self.model):
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

    def _batch_losses(self, x_start, valid, inputs, generator, plan, b, rows=None):
        model = self.model
        denom = (valid.sum() if rows is None else rows.count(valid.sum())).clamp(min=1.0)
        for m in MODALITIES:
            drawn = {} if plan is None else {k: plan[f"{k}_{m}"][b].to(model.device) for k in ("ts", "noise", "keep")}
            drawn = pm.item_planes(drawn, model.item_cols)
            if rows is not None:
                drawn = rows.local(drawn or model.diffusion_draws(rows.n, generator))
            denoiser = getattr(model, f"denoise_{m}")
            diff, gc = model.diffusion_losses(
                denoiser, x_start, inputs["i_embeds"], inputs[m], generator=generator, **drawn
            )
            yield f"denoise_{m}", ((diff * valid).sum() + model.e_loss * (gc * valid).sum()) / denom

    def _regenerated_graphs(self, generator, plan) -> dict:
        """Each modality's graph from each user's top ``rebuild_k`` items of
        the reverse-diffused vector (K3; on the item split K3 on each rank's
        columns, merged)."""
        if plan is not None:
            raise ValueError("DiffMM's phase 2 takes no plan")
        model = self.model
        cols = model.item_cols

        def graph(denoiser):
            def chunk_topk(c, users, noise=None):
                x = interaction_vectors(model.data, users, cols)
                den = model.p_sample_users(denoiser, x, generator, noise)
                return (grouped_topk(den, model.rebuild_k) if cols is None else cols.topk(den, model.rebuild_k))[1]

            draws = lambda n: {"noise": model.sample_noise((n, model.n_items), generator)}
            return model.rebuild_ui_graph(self._top_items(chunk_topk, draws), generator)

        return {"image_ui": graph(model.denoise_image), "text_ui": graph(model.denoise_text)}

    def _loss_log(self, losses) -> dict:
        steps = losses.shape[0]
        return {f"diffusion_loss_{m}": float(losses[:, j].sum()) / steps for j, m in enumerate(MODALITIES)}


class GenRecV1Trainer(_DiffusionTrainer):
    def __init__(self, config, model, mg: bool = False, mesh=None):
        super().__init__(config, model, mg, mesh)
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

    def _batch_losses(self, x_start, valid, inputs, generator, plan, b, rows=None):
        """The denoiser's loss over all B rows, padded ones included, as in
        the JAX package. ``plan`` may give, per batch, the draws of
        ``diffusion_losses`` (``draws``, a list of dicts)."""
        model = self.model
        draws = None if plan is None else pm.item_planes(plan["draws"][b], model.item_cols)
        if rows is not None:
            draws = rows.local(draws or model.diffusion_draws(rows.n, generator))
        yield "denoise_image", model.diffusion_losses(
            x_start, inputs["i_embeds"], inputs["image"], inputs["text"], generator, draws, rows
        )

    @torch.no_grad()
    def generate_chunk(self, users, generator=None, draws: Optional[dict] = None, sampled=None):
        """Phase 2 for one chunk of users: ``generate``, then the interest
        debias when the tables exist → (blended, probs), each (B, n_items).
        ``draws`` and ``sampled`` are ``generate``'s and
        ``interest_debias``'s draws."""
        model = self.model
        cols = model.item_cols
        x_start = interaction_vectors(model.data, users, cols)
        blended, probs = model.generate(x_start, generator, draws)
        if self.debias_tables is not None:
            tables = self.debias_tables
            if cols is not None:
                # this rank's items: their cluster labels, and its columns of the draw
                tables = {**tables, **{k: cols.rows(tables[k]) for k in ("img_labels", "txt_labels")}}
                if sampled is None:
                    sampled = self._debias_draw(users.shape[0], generator)
            blended = interest_debias(users, x_start, blended, tables, self.sample_ratio, generator, sampled)
        return blended, probs

    def _debias_draw(self, n: int, generator=None) -> torch.Tensor:
        """``interest_debias``'s sampled plane for ``n`` users, in its order;
        on the item split this rank's columns of it."""
        model = self.model
        sampled = torch.rand(n, model.n_items, generator=generator, device=model.device) < self.sample_ratio
        return pm.item_planes(sampled, model.item_cols)

    def _regenerated_graphs(self, generator, plan) -> dict:
        """``image_ui`` from each user's top ``rebuild_k`` of blended · probs
        (K3). ``plan`` may give, per chunk, ``gen`` (``generate``'s draws)
        and ``sampled`` (the debias plane), and ``keep`` (the edge
        dropout's two masks), in place of the draws."""

        model = self.model
        cols = model.item_cols

        def chunk_topk(c, users, draws=None, sampled=None):
            if plan is not None:
                draws, sampled = pm.item_planes((plan["gen"][c], plan["sampled"][c]), cols)
            blended, probs = self.generate_chunk(users, generator, draws, sampled)
            scores = blended * probs
            return (grouped_topk(scores, model.rebuild_k) if cols is None else cols.topk(scores, model.rebuild_k))[1]

        def chunk_draws(n):
            draws = {"draws": model.generate_draws(n, generator)}
            if self.debias_tables is not None:
                draws["sampled"] = self._debias_draw(n, generator)
            return draws

        keep = None if plan is None else plan["keep"]
        top = self._top_items(chunk_topk, None if plan is not None else chunk_draws)
        return {"image_ui": model.rebuild_ui_graph(top, generator, keep)}

    def _loss_log(self, losses) -> dict:
        return {"diffusion_loss": float(losses.sum()) / losses.shape[0]}


class MVDiffTrainer(Trainer):
    """MVDiff's four phases before each BPR epoch, in this order, from one
    generator (``_epoch_prelude``, timed apart into ``prelude_log``):

    1. ``feature_epoch``: each modality's feature denoiser, with its own
       Adam, over the items in batches of ``train_batch_size``;
    2. ``regenerate_items``: both reverse chains over every item plus the
       original features rebuild the item-item graphs and planes;
    3. ``sparsity_epoch``: each modality's sparsity denoiser, with its own
       Adam, over the users' interaction vectors;
    4. ``regenerate_users``: the two user-item graphs from the reverse
       chains of the sparsity denoisers (``MVDiff.ui_topk``), chunk by
       chunk of ``train_batch_size`` users.

    Each epoch's batches are a permutation of the padded slots; a slot past
    the last item or user repeats the last one (weight 0 in the loss, but
    in the batch norms, as in the JAX package). A ``plan`` may give each
    phase's draws.

    On a data axis the batches of phases 1 and 3 split over the ranks as
    the BPR batches do (every draw made at the global batch and sliced, a
    plan's draws the global batch's): the weighted means take the global
    valid count, the batch norms and phase 3's sparsity and InfoNCE every
    rank's rows, and each denoiser's Adam steps on gradients summed over
    the axis. Phase 4 deals its user chunks over the ranks
    (``dealt_chunks``) and every rank builds the graphs from every chunk's
    picks; phase 2 runs whole on every rank. On a model axis phases 3 and 4
    run on the item split (``MVDiff.split_items``); phases 1 and 2, over
    the items' features, run whole on every rank."""

    # the parameter groups trained in phases 1 and 3, one Adam each
    DENOISERS = ("feat_denoise_image", "feat_denoise_text", "denoise_image", "denoise_text")

    def _build_train_step(self, train_data) -> None:
        super()._build_train_step(train_data)
        split_items(self)
        self._build_phase_optimizers()

    def _split_items(self) -> None:
        split_items(self)

    def _build_phase_optimizers(self) -> None:
        """One plain Adam per denoiser, at the main learning rate."""
        lr = scalar(self.config["learning_rate"])
        groups = self.model.param_groups()
        for name in self.DENOISERS:
            self.optimizers[name] = ChainOptimizer(groups[name], "adam", lambda step: lr)

    def _slots(self, n: int, generator, plan) -> torch.Tensor:
        B = self.train_batch_size
        if plan is not None:
            return plan["idx"].to(self.model.device)
        nb = -(-n // B)
        return torch.randperm(nb * B, generator=generator, device=self.model.device).reshape(nb, B)

    def _step(self, name: str, loss, rows=None) -> torch.Tensor:
        """One step of denoiser ``name``'s Adam; over ``rows`` on gradients
        summed over the data axis."""
        opt = self.optimizers[name]
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if rows is not None:
            pm.reduce_grads(self._step_params([name]), self.mesh)
        opt.step()
        opt.zero_grad(set_to_none=True)
        return loss.detach()

    @torch.enable_grad()
    def feature_epoch(self, generator: Optional[torch.Generator] = None, plan: Optional[dict] = None):
        """Phase 1; returns the (n_batches, 2) losses (image, text) on the
        device. ``plan`` may give the slots (``idx``, (n_batches, B)) and
        per batch and modality the timesteps and noise (``draws[b][j]``,
        a (ts, noise) pair)."""
        if "feat_denoise_image" not in self.optimizers:
            split_items(self)
            self._build_phase_optimizers()
        full_precision_matmuls()
        model = self.model
        I = model.n_items
        rows = pm.data_sharding(self.mesh, self.train_batch_size)
        losses = []
        for b, slots in enumerate(self._slots(I, generator, plan)):
            idx = slots if rows is None else rows.local(slots)
            valid = (idx < I).to(torch.float32)
            ii = idx.clamp(max=I - 1)
            x_img, x_txt = model.v_feat[ii], model.t_feat[ii]
            step = []
            for j, m in enumerate(MODALITIES):
                dim = x_img.shape[1] if m == "image" else x_txt.shape[1]
                if plan is not None:
                    ts, noise = (t.to(model.device) for t in plan["draws"][b][j])
                else:
                    ts = torch.randint(0, model.steps, slots.shape, generator=generator, device=model.device)
                    noise = torch.randn(slots.shape[0], dim, generator=generator, device=model.device)
                if rows is not None:
                    ts, noise = rows.local((ts, noise))
                with pm.whole_tables(model):
                    per = model.feat_diffusion_loss(m, x_img, x_txt, ts, noise, rows)
                step.append(self._step(f"feat_denoise_{m}", weighted_mean(per, valid, rows), rows))
            losses.append(torch.stack(step))
        losses = torch.stack(losses)
        return losses if rows is None else pm.all_reduce(losses, self.mesh, pm.DATA_AXIS)

    @torch.no_grad()
    def regenerate_items(self) -> dict:
        """Phase 2: the item-item graphs of ``self.state`` from both feature
        denoisers' reverse chains plus the original features."""
        full_precision_matmuls()
        model = self.model
        with pm.whole_tables(model):
            den_img = model.feat_p_sample("image") + model.v_feat
            den_txt = model.feat_p_sample("text") + model.t_feat
            self.state = {**self.state, **model.ii_state(den_img, den_txt)}
        return self.state

    @torch.enable_grad()
    def sparsity_epoch(self, generator: Optional[torch.Generator] = None, plan: Optional[dict] = None):
        """Phase 3; returns the (n_batches, 2) losses (image, text) on the
        device. The item embeddings and the modal projections (without
        dropout) are read once, detached. ``plan`` may give the slots
        (``idx``) and per batch and modality ``sparsity_losses``' draws
        (``draws[b][j]``)."""
        if "denoise_image" not in self.optimizers:
            split_items(self)
            self._build_phase_optimizers()
        full_precision_matmuls()
        model = self.model
        cols = model.item_cols
        U = model.n_users
        with torch.no_grad(), pm.whole_tables(model):
            i_emb = model.item_id_embedding.detach().clone()
            feats = {m: model.modal_feats(m) for m in MODALITIES}
        rows = pm.data_sharding(self.mesh, self.train_batch_size)
        losses = []
        for b, slots in enumerate(self._slots(U, generator, plan)):
            users = slots if rows is None else rows.local(slots)
            valid = (users < U).to(torch.float32)
            x = interaction_vectors(model.data, users.clamp(max=U - 1), cols) * valid[:, None]
            step = []
            for j, m in enumerate(MODALITIES):
                if plan is not None:
                    draws = pm.item_planes(_to_device(plan["draws"][b][j], model.device), cols)
                else:
                    draws = model.sparsity_draws(generator, slots.shape[0])
                if rows is not None:
                    draws = rows.local(draws)
                with pm.whole_tables(model):
                    diff, gc, contra = model.sparsity_losses(
                        getattr(model, f"denoise_{m}"), x, i_emb, feats[m], draws, rows)
                wmean = lambda v: weighted_mean(v, valid, rows)
                loss = wmean(diff) + model.e_loss * wmean(gc) + model.ssl_reg * wmean(contra)
                step.append(self._step(f"denoise_{m}", loss, rows))
            losses.append(torch.stack(step))
        losses = torch.stack(losses)
        return losses if rows is None else pm.all_reduce(losses, self.mesh, pm.DATA_AXIS)

    @torch.no_grad()
    def regenerate_users(self, generator: Optional[torch.Generator] = None, plan: Optional[dict] = None) -> dict:
        """Phase 4: ``image_ui`` and ``text_ui`` of ``self.state`` from each
        user's picks (``MVDiff.ui_topk``), in chunks of ``train_batch_size``
        users (the last padded with the last user). ``plan`` may give the
        two graphs' dropout masks (``keep``: {"image": (m_ui, m_loop),
        "text": ...})."""
        full_precision_matmuls()
        split_items(self)
        model = self.model
        U, B = model.n_users, self.train_batch_size
        chunks = torch.arange(-(-U // B) * B, device=model.device).clamp_(max=U - 1).split(B)
        keep = {} if plan is None else _to_device(plan["keep"], model.device)
        graphs = {}
        with pm.whole_tables(model):
            for m in MODALITIES:
                width = model.rebuild_k + (model.high_order_topk if m == "image" else 0)
                picks = lambda c, users: model.ui_topk(self.state, m, users)
                items = dealt_chunks(self.mesh, list(chunks), picks, width)[:U]
                graphs[f"{m}_ui"] = model.rebuild_ui_graph(items, generator, keep.get(m))
        self.state = {**self.state, **graphs}
        return self.state

    def _epoch_prelude(self, generator: torch.Generator, epoch_idx: int) -> None:
        """The four phases, each timed to its end on the device."""
        cuda = self.model.device.type == "cuda"
        sync = lambda: torch.cuda.synchronize(self.model.device) if cuda else None
        t0 = time.time()
        feat = self.feature_epoch(generator).cpu()
        t1 = time.time()
        self.regenerate_items()
        sync()
        t2 = time.time()
        sparse = self.sparsity_epoch(generator).cpu()
        t3 = time.time()
        self.regenerate_users(generator)
        sync()
        t4 = time.time()
        mean = lambda losses, j: float(losses[:, j].sum()) / max(1, losses.shape[0])
        self.prelude_log = {
            "feature_s": t1 - t0, "regenerate_items_s": t2 - t1, "sparsity_s": t3 - t2, "regenerate_users_s": t4 - t3,
            **{f"feature_loss_{m}": mean(feat, j) for j, m in enumerate(MODALITIES)},
            **{f"sparsity_loss_{m}": mean(sparse, j) for j, m in enumerate(MODALITIES)},
        }
        log = self.prelude_log
        self.logger.info(
            "MVDiff Losses - Feature Diffusion: Image=%.4f, Text=%.4f; Interaction Diffusion: Image=%.4f, "
            "Text=%.4f [%.2fs]", log["feature_loss_image"], log["feature_loss_text"], log["sparsity_loss_image"],
            log["sparsity_loss_text"], t4 - t0,
        )


def _to_device(value, device):
    if torch.is_tensor(value):
        return value.to(device)
    if isinstance(value, dict):
        return {k: _to_device(v, device) for k, v in value.items()}
    return type(value)(_to_device(v, device) for v in value)
