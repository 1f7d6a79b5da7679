"""Trainer (counterpart of ``genmmrec_tpu/engine/trainer.py``).

Training: ``fit`` runs, per epoch, the model's ``pre_epoch`` hook, the
multi-phase trainers' ``_epoch_prelude`` and the BPR epoch, then evaluates
every ``eval_step`` epochs with early stopping on the valid metric, keeps
the best valid and test results, and saves a checkpoint on improvement.
An epoch is a Python loop over batches of a permutation padded to whole
batches (padding rows weigh 0); negatives, loss, backward and the optimizer
step stay on the device, and the losses are read back once per epoch.

Randomness: the trainer holds a ``torch.Generator`` seeded from
``config["seed"]`` on the model's device, and derives one generator for
each use (init, state, and each epoch's pre-epoch, prelude and train
draws) from the seed and the use's name, as the JAX package splits and
folds its keys. Torch's draws differ from JAX's; the tests inject the JAX
package's draws as tensors.

Evaluation: a model with ``full_embeddings`` or ``eval_artifacts`` has
its artifacts (the full user and item embeddings) computed once per
evaluation and scores ``u @ iᵀ`` in its ``eval_dtype``, float32 or bfloat16
(bfloat16 operands, float32 sums, one rounding); a model with ``scores``
alone is scored chunk by chunk. Users go in chunks of ``eval_batch_size``
to a top-k that excludes their train positives, and on to the metric
suite. A chunk takes one of three routes:

- plane: ``scores_cached`` writes the chunk's (B, n_items) scores in
  either type and K3 (``ops/topk.py``) takes the masked top-k over the
  bit-packed mask, or, with ``GENMMREC_PALLAS_TOPK`` set and a catalog of
  more than 2k groups of 128 items, the two-stage route over K4 does;
- fused: bfloat16 with the base ``scores_cached`` and ``(u_emb, i_emb)``
  artifacts of a width the K5 kernels take (``KERNEL_WIDTHS``, at most 128)
  goes through K5 (``ops/fused_topk.py``), which writes no score plane; a
  wider embedding takes the plane route in bfloat16, on every device;
- scatter: a packed mask over ``_DENSE_MASK_BUDGET`` is not built; each
  chunk's plane gets ``-1e10`` scattered over its users' train positives
  and K3 takes the unmasked top-k.
"""

from __future__ import annotations

import os
import time
from logging import getLogger
from typing import Optional

import numpy as np
import torch

from genmmrec_tpu_torch.data.arrays import EvalData, TrainData, sample_negatives
from genmmrec_tpu_torch.engine.checkpoint import load_checkpoint, save_checkpoint
from genmmrec_tpu_torch.engine.evaluator import TopKEvaluator
from genmmrec_tpu_torch.models.base import RecModel, scalar
from genmmrec_tpu_torch.ops.fused_topk import KERNEL_WIDTHS, fused_grouped_topk
from genmmrec_tpu_torch.ops.precision import full_precision_matmuls
from genmmrec_tpu_torch.ops.topk import grouped_topk
from genmmrec_tpu_torch.utils.misc import dict2str, early_stopping

# width granularity of the packed mask: rows are padded to a multiple of
# this many columns, with the pad columns marked as excluded
MASK_GROUP = 128


class ChainOptimizer(torch.optim.Optimizer):
    """The JAX package's optax chain, step for step:
    ``clip_by_global_norm`` (when ``max_norm``) → ``add_decayed_weights``
    (coupled decay, when ``weight_decay``) → ``scale_by_<learner>`` →
    ``-lr_fn(count)``, where ``count`` is the number of earlier steps.

    ``learner`` is adam (b1 0.9, b2 0.999, eps 1e-8), sgd (identity),
    adagrad (``scale_by_rss``, accumulator 0, eps 1e-7 inside the root) or
    rmsprop (``scale_by_rms``, decay 0.9, eps 1e-8 inside the root). A
    parameter without a gradient steps as if its gradient were zero, as a
    leaf of an optax tree does."""

    LEARNERS = ("adam", "sgd", "adagrad", "rmsprop")

    def __init__(self, params, learner: str, lr_fn, max_norm=None, weight_decay: float = 0.0):
        if learner not in self.LEARNERS:
            raise ValueError(f"unknown learner {learner}")
        super().__init__(params, {})
        self.learner, self.lr_fn = learner, lr_fn
        self.max_norm, self.weight_decay = max_norm, weight_decay
        self.count = 0

    def state_dict(self):
        out = super().state_dict()
        out["count"] = self.count
        return out

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        self.count = int(state_dict.pop("count"))
        super().load_state_dict(state_dict)

    @torch.no_grad()
    def step(self, closure=None):
        params = [p for group in self.param_groups for p in group["params"]]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        if self.max_norm is not None:
            norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
            scale = torch.where(norm < self.max_norm, 1.0, self.max_norm / norm)
            grads = [g * scale for g in grads]
        if self.weight_decay:
            grads = [g + self.weight_decay * p for g, p in zip(grads, params)]
        lr = self.lr_fn(self.count)
        t = self.count + 1
        for p, g in zip(params, grads):
            # moments are replaced, never updated in place: a loaded state
            # dict may share its tensors with another optimizer's
            st = self.state[p]
            if self.learner == "adam":
                st["mu"] = 0.9 * st.get("mu", 0.0) + 0.1 * g
                st["nu"] = 0.999 * st.get("nu", 0.0) + 0.001 * (g * g)
                u = (st["mu"] / (1 - 0.9**t)) / ((st["nu"] / (1 - 0.999**t)).sqrt() + 1e-8)
            elif self.learner == "adagrad":
                st["sum_of_squares"] = st.get("sum_of_squares", 0.0) + g * g
                sq = st["sum_of_squares"]
                u = torch.where(sq > 0, torch.rsqrt(sq + 1e-7), 0.0) * g
            elif self.learner == "rmsprop":
                st["nu"] = 0.9 * st.get("nu", 0.0) + 0.1 * (g * g)
                u = g * torch.rsqrt(st["nu"] + 1e-8)
            else:
                u = g
            p.add_(u, alpha=-lr)
        self.count += 1


def make_optimizer(params, config, steps_per_epoch: int) -> ChainOptimizer:
    """The main optimizer from the config: ``learner``, ``learning_rate``,
    ``weight_decay``, ``clip_grad_norm`` and the per-epoch schedule
    ``lr · s0^(epoch / s1)`` of ``learning_rate_scheduler``, stepped per
    batch (epoch = step // steps_per_epoch)."""
    lr = scalar(config["learning_rate"])
    s0, s1 = (float(v) for v in (config["learning_rate_scheduler"] or [1.0, 50]))
    steps_per_epoch = max(1, steps_per_epoch)
    lr_fn = lambda step: lr * s0 ** ((step // steps_per_epoch) / s1)
    name = str(config["learner"] or "adam").lower()
    if name not in ChainOptimizer.LEARNERS:
        getLogger().warning("Unrecognized optimizer %s; using adam", name)
        name = "adam"
    clip = config["clip_grad_norm"]
    max_norm = None
    if clip:
        max_norm = float(clip.get("max_norm") if isinstance(clip, dict) else clip)
    wd = config["weight_decay"]
    wd = float(wd[0] if isinstance(wd, list) else wd) if wd else 0.0
    return ChainOptimizer(params, name, lr_fn, max_norm=max_norm, weight_decay=wd)


def seeded_generator(device, seed: int, *path) -> torch.Generator:
    """A generator on ``device`` seeded from ``seed`` and a path of names
    and numbers: the same path gives the same draws, different paths give
    independent streams (``jax.random.split``/``fold_in`` in the JAX
    package)."""
    words = [seed] + [int.from_bytes(str(p).encode(), "little") for p in path]
    child = int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]) & ((1 << 63) - 1)
    return torch.Generator(device=device).manual_seed(child)


def get_trainer(model_name: Optional[str] = None):
    """The trainer class of a model (the JAX package's ``get_trainer``):
    DiffMM and GenRecV1 have their multi-phase trainers, every other model
    ``Trainer``. MVDiff's trainer is not ported yet and raises."""
    from genmmrec_tpu_torch.engine import diffusion_trainers as dt

    if model_name == "MVDiff":
        raise NotImplementedError(
            "MVDiffTrainer is not ported to genmmrec_tpu_torch yet (ROADMAP.md, Queue 1 item 9)"
        )
    return {"DiffMM": dt.DiffMMTrainer, "GenRecV1": dt.GenRecV1Trainer}.get(model_name, Trainer)


class Trainer:
    # packed (uint8) mask budget in bytes; past it no mask is built and the
    # evaluation takes the per-chunk scatter route
    _DENSE_MASK_BUDGET = 2 * 1024 * 1024 * 1024
    # where the fused route applies the mask to the candidates: in K5b
    # ("kernel") or after K5c in plain PyTorch ("external"); same result
    _FUSED_CAND_MASK = "kernel"

    def __init__(self, config, model):
        self.config = config
        self.model = model
        self.logger = getLogger()
        self.epochs = int(config["epochs"])
        self.eval_step = min(int(config["eval_step"] or 1), self.epochs)
        self.stopping_step = int(config["stopping_step"])
        self.valid_metric = str(config["valid_metric"]).lower()
        self.valid_metric_bigger = bool(config["valid_metric_bigger"])
        self.eval_batch_size = int(config["eval_batch_size"])
        self.train_batch_size = int(config["train_batch_size"])
        self.req_training = bool(config["req_training"])
        self.neg_rounds = int(config["neg_sample_rounds"] or 8)
        self.use_neg = bool(config["use_neg_sampling"])
        seed = int(scalar(config["seed"], default=0))
        self.generator = torch.Generator(device=model.device).manual_seed(seed)

        self.start_epoch = 0
        self.cur_step = 0
        init_metrics = {f"{m.lower()}@{k}": 0.0 for m in config["metrics"] for k in config["topk"]}
        self.best_valid_score = -1.0
        self.best_valid_result = init_metrics
        self.best_test_upon_valid = init_metrics
        self.train_loss_dict = {}
        # wall time per training epoch (prelude included), in fit order
        self.epoch_times: list[float] = []
        self.evaluator = TopKEvaluator(config)
        # group masks for test-time metrics (engine.evaluator.group_masks)
        self.pop_mask = config["pop_mask"]
        self.warm_mask = config["warm_mask"]
        self.state = model.init_state(self.split("state"))
        # name -> optimizer; all of them go into a checkpoint
        self.optimizers: dict = {}
        self._mask_cache = {}

    def split(self, *path) -> torch.Generator:
        """A generator for one use, derived from the seed (``seeded_generator``)."""
        return seeded_generator(self.generator.device, self.generator.initial_seed(), *path)

    # ------------------------------------------------------------------
    def _build_train_step(self, train_data: TrainData) -> None:
        """Batch plan and main optimizer, over the model's ``rec`` parameters."""
        self._td = train_data
        self._num_batches = -(-train_data.n_inter // self.train_batch_size)
        params = self.model.param_groups()["rec"]
        self.optimizers["main"] = make_optimizer(params, self.config, self._num_batches)

    @torch.enable_grad()
    def _train_epoch(self, generator: Optional[torch.Generator] = None, plan: Optional[dict] = None):
        """One BPR epoch; returns the (n_batches, n_parts) per-batch losses,
        on the device.

        The batches are rows of a permutation of ``n_pad = n_batches · B``
        slots; slot ``raw`` reads interaction ``raw % n_inter`` with weight
        ``raw < n_inter``. ``plan`` may give the slots (``idx``, (any number
        of batches, B)) and the negatives (``neg``, same shape) in place of
        the draws; the epoch then runs the plan's batches.
        """
        model, td, opt = self.model, self._td, self.optimizers["main"]
        B, nb, n_inter = self.train_batch_size, self._num_batches, td.n_inter
        dev = td.users.device
        if plan is not None:
            idxs = plan["idx"].to(dev)
        else:
            idxs = torch.randperm(nb * B, generator=generator, device=dev).reshape(nb, B)
        parts_all = []
        for b in range(idxs.shape[0]):
            raw = idxs[b]
            weight = (raw < n_inter).to(torch.float32)
            idx = raw % n_inter
            users, pos = td.users[idx], td.items[idx]
            if plan is not None and "neg" in plan:
                neg = plan["neg"][b].to(dev)
            elif self.use_neg:
                neg = sample_negatives(users, td.hist, td.item_pool, td.n_pool, self.neg_rounds, generator)
            else:
                neg = torch.zeros_like(pos)
            batch = {"users": users, "pos": pos, "neg": neg, "weight": weight}
            opt.zero_grad(set_to_none=True)
            total, (parts, self.state) = model.loss_and_update(self.state, batch, generator)
            total.backward()
            opt.step()
            parts_all.append(torch.stack([p.detach() for p in parts]))
        opt.zero_grad(set_to_none=True)
        return torch.stack(parts_all)

    def _epoch_prelude(self, generator: torch.Generator, epoch_idx: int) -> None:
        """Hook for the multi-phase trainers, run before each BPR epoch."""

    # ------------------------------------------------------------------
    def fit(self, train_data: TrainData, valid_data=None, test_data=None, saved=False, verbose=True):
        """Initialize the model from the seed, train ``epochs`` epochs (or
        resume from ``resume_checkpoint``), evaluate every ``eval_step``
        epochs with early stopping; returns (best valid score, best valid
        result, test result at the best valid)."""
        model = self.model
        model.init_params(self.split("init"))
        self.state = model.init_state(self.split("state"))
        self._build_train_step(train_data)
        resume = self.config["resume_checkpoint"]
        if resume:
            self._resume(str(resume))
        if verbose:
            n = sum(p.numel() for p in model.parameters())
            self.logger.info("%s\nTrainable parameters: %d", type(model).__name__, n)

        for epoch_idx in range(self.start_epoch, self.epochs):
            t0 = time.time()
            self.state = model.pre_epoch(self.state, self.split("epoch", epoch_idx, "pre"), epoch_idx)
            self._epoch_prelude(self.split("epoch", epoch_idx, "prelude"), epoch_idx)
            if self.req_training:
                totals = self._train_epoch(self.split("epoch", epoch_idx, "train")).sum(dim=0).cpu().numpy()
                if not np.all(np.isfinite(totals)):
                    self.logger.info("Loss is nan at epoch: %d. Exiting.", epoch_idx)
                    break
                train_loss = tuple(totals.tolist()) if totals.size > 1 else float(totals[0])
            else:
                train_loss = 0.0
            self.train_loss_dict[epoch_idx] = sum(train_loss) if isinstance(train_loss, tuple) else train_loss
            t1 = time.time()
            self.epoch_times.append(t1 - t0)
            if verbose:
                if isinstance(train_loss, tuple):
                    loss_str = ", ".join(f"train_loss{i + 1}: {l:.4f}" for i, l in enumerate(train_loss))
                else:
                    loss_str = f"train loss: {train_loss:.4f}"
                self.logger.info("epoch %d training [time: %.2fs, %s]", epoch_idx, t1 - t0, loss_str)
            post_info = model.post_epoch(self.state)
            if post_info is not None and verbose:
                self.logger.info(post_info)

            if valid_data is None or (epoch_idx + 1) % self.eval_step != 0:
                continue
            tv0 = time.time()
            valid_result = self.evaluate(valid_data)
            valid_score = valid_result[self.valid_metric]
            self.best_valid_score, self.cur_step, stop_flag, update_flag = early_stopping(
                valid_score, self.best_valid_score, self.cur_step,
                max_step=self.stopping_step, bigger=self.valid_metric_bigger,
            )
            tv1 = time.time()
            test_result = self.evaluate(test_data, is_test=True) if test_data is not None else {}
            if verbose:
                self.logger.info(
                    "epoch %d evaluating [time: %.2fs, valid_score: %f]", epoch_idx, tv1 - tv0, valid_score
                )
                self.logger.info("valid result: \n%s", dict2str(valid_result))
                self.logger.info("test result: \n%s", dict2str(test_result))
            if update_flag:
                if verbose:
                    self.logger.info("██ %s--Best validation results updated!!!", self.config["model"])
                self.best_valid_result = valid_result
                self.best_test_upon_valid = test_result
                if saved:
                    self._save_checkpoint(epoch_idx)
            if stop_flag:
                if verbose:
                    self.logger.info(
                        "+++++Finished training, best eval result in epoch %d",
                        epoch_idx - self.cur_step * self.eval_step,
                    )
                break
        return self.best_valid_score, self.best_valid_result, self.best_test_upon_valid

    # ------------------------------------------------------------------
    def checkpoint_path(self) -> str:
        ckpt_dir = self.config["checkpoint_dir"] or "saved"
        return os.path.join(ckpt_dir, f"{self.config['model']}-{self.config['dataset']}")

    def _save_checkpoint(self, epoch: int) -> str:
        path = save_checkpoint(
            self.checkpoint_path(),
            params=self.model.state_dict(),
            optimizers={k: opt.state_dict() for k, opt in self.optimizers.items()},
            state=self.state,
            epoch=epoch,
            best_valid_score=self.best_valid_score,
            best_valid_result=self.best_valid_result,
            best_test_upon_valid=self.best_test_upon_valid,
        )
        self.logger.info("Saved best model to %s", path)
        return path

    def _resume(self, path: str) -> None:
        ck = load_checkpoint(path, map_location=self.model.device)
        self.model.load_state_dict(ck["params"])
        for name, opt_state in ck["optimizers"].items():
            self.optimizers[name].load_state_dict(opt_state)
        self.state = ck["state"]
        self.start_epoch = int(ck["epoch"]) + 1
        self.best_valid_score = float(ck["best_valid_score"])
        self.best_valid_result = ck["best_valid_result"]
        self.best_test_upon_valid = ck["best_test_upon_valid"]
        self.logger.info(
            "Resumed from %s at epoch %d (best valid %.4f)", path, self.start_epoch, self.best_valid_score
        )

    def _dense_mask(self, eval_data: EvalData) -> Optional[torch.Tensor]:
        """(U_pad, n_pad/8) uint8 little-endian bit matrix of each user's
        train positives, n_pad the MASK_GROUP multiple above n_items, pad
        columns set. Built once per eval set on the host, in user slabs.
        None when it would exceed ``_DENSE_MASK_BUDGET``."""
        U_pad = eval_data.users.shape[0]
        n_items = eval_data.n_items
        n_pad = -(-n_items // MASK_GROUP) * MASK_GROUP
        if U_pad * (n_pad // 8) > self._DENSE_MASK_BUDGET:
            return None
        cached = self._mask_cache.get(id(eval_data))
        if cached is not None:
            return cached[1]
        m = eval_data.mask_items.cpu().numpy()
        packed_np = np.empty((U_pad, n_pad // 8), np.uint8)
        slab = max(1, (256 << 20) // n_pad)  # ≤256 MB bool slab
        for lo in range(0, U_pad, slab):
            hi = min(lo + slab, U_pad)
            ms = m[lo:hi]
            valid = (ms < n_items).reshape(-1)
            rows = np.repeat(np.arange(hi - lo), ms.shape[1])[valid]
            cols = ms.reshape(-1)[valid]
            dense_np = np.zeros((hi - lo, n_pad), bool)
            dense_np[:, n_items:] = True
            dense_np[rows, cols] = True
            packed_np[lo:hi] = np.packbits(dense_np, axis=1, bitorder="little")
        packed = torch.as_tensor(packed_np, device=eval_data.users.device)
        # holding eval_data keeps its id from being reused
        self._mask_cache[id(eval_data)] = (eval_data, packed)
        return packed

    @torch.no_grad()
    def eval_topk(self, eval_data: EvalData) -> torch.Tensor:
        """(U_pad, max_k) top-k item ids, train positives excluded; -1 pads
        catalogs narrower than max_k."""
        full_precision_matmuls()
        model = self.model
        max_k = self.evaluator.max_k
        n_items = model.n_items
        k_eff = min(max_k, n_items)
        B = self.eval_batch_size
        mask = self._dense_mask(eval_data)
        # as the reference: artifacts once per evaluation where the model
        # defines them, else ``scores`` chunk by chunk
        mtype = type(model)
        has_cache = (
            mtype.eval_artifacts is not RecModel.eval_artifacts
            or mtype.full_embeddings is not RecModel.full_embeddings
        )
        if not has_cache and mtype.scores is RecModel.scores:
            raise NotImplementedError(
                f"{mtype.__name__} defines neither full_embeddings (or eval_artifacts) nor scores: "
                "it cannot be evaluated"
            )
        arts = model.eval_artifacts(self.state) if has_cache else None
        # bfloat16 scores that are the base class's u @ iᵀ can be computed
        # inside the top-k (K5); a model with scores of its own writes its plane
        fused = (
            has_cache
            and mask is not None
            and model.eval_dtype == torch.bfloat16
            and mtype.scores_cached is RecModel.scores_cached
        )
        if fused:
            if not (
                isinstance(arts, tuple)
                and len(arts) == 2
                and all(torch.is_tensor(a) and a.dim() == 2 for a in arts)
                and arts[1].shape[0] == n_items
            ):
                raise RuntimeError(
                    "bfloat16 evaluation with the base scores_cached needs (u_emb, i_emb) artifacts "
                    "with one i_emb row per item"
                )
            # the route rule of the width, the same on every device: K5's
            # kernels are built up to KERNEL_WIDTHS[-1]; a wider embedding
            # takes the plane route, bfloat16 scores and K3 with the packed
            # mask, which gives the same exact top-k of the bf16 scores
            fused = arts[1].shape[1] <= KERNEL_WIDTHS[-1]
        if fused:
            u_emb, table = arts[0], arts[1].bfloat16()
        out = []
        for lo in range(0, eval_data.users.shape[0], B):
            users = eval_data.users[lo : lo + B]
            if fused:
                _, top = fused_grouped_topk(
                    u_emb[users], table, k_eff, mask[lo : lo + B], cand_mask=self._FUSED_CAND_MASK
                )
            else:
                if has_cache:
                    scores = model.scores_cached(self.state, users, arts)
                else:
                    scores = model.scores(self.state, users)
                if mask is not None:
                    _, top = grouped_topk(scores, k_eff, packed_mask=mask[lo : lo + B])
                else:
                    # -1e10 over each row's train positives; the pad entries
                    # (n_items) of mask_items are dropped
                    m = eval_data.mask_items[lo : lo + B]
                    real = m < n_items
                    rows = torch.arange(m.shape[0], device=m.device)[:, None].expand_as(m)
                    scores[rows[real], m[real]] = -1e10
                    _, top = grouped_topk(scores, k_eff)
            if k_eff < max_k:
                top = torch.nn.functional.pad(top, (0, max_k - k_eff), value=-1)
            out.append(top)
        return torch.cat(out)

    def evaluate(self, eval_data: EvalData, is_test: bool = False, idx: int = 0):
        topk_index = self.eval_topk(eval_data)
        return self.evaluator.evaluate(
            topk_index,
            eval_data,
            pop_mask=self.pop_mask,
            warm_mask=self.warm_mask if is_test else None,
            is_test=is_test,
            idx=idx,
        )
