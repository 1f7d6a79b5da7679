"""Trainer, evaluation half (counterpart of ``genmmrec_tpu/engine/trainer.py``).

Full-catalog evaluation: the model's full user and item embeddings are
computed once per evaluation, then users go in chunks of
``eval_batch_size`` through scoring (``u @ iᵀ`` in float32), the masked
top-k (K3, ``ops/topk.py``) over the bit-packed train-positive mask, and the
metric suite. The training loop comes with training.
"""

from __future__ import annotations

import numpy as np
import torch

from genmmrec_tpu_torch.data.arrays import EvalData
from genmmrec_tpu_torch.engine.evaluator import TopKEvaluator
from genmmrec_tpu_torch.ops.topk import grouped_topk

# width granularity of the packed mask: rows are padded to a multiple of
# this many columns, with the pad columns marked as excluded
MASK_GROUP = 128


def full_precision_matmuls() -> None:
    """Keep float32 products in full float32: TF32 would keep about three
    decimal digits, and the scores only feed a top-k whose order must match
    the float32 reference. Set explicitly for both cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Trainer:
    # packed (uint8) mask budget; a larger mask raises (the per-chunk
    # scatter path the JAX package takes past it is not ported yet)
    _DENSE_MASK_BUDGET = 2 * 1024 * 1024 * 1024

    def __init__(self, config, model):
        self.config = config
        self.model = model
        self.eval_batch_size = int(config["eval_batch_size"])
        self.train_batch_size = int(config["train_batch_size"])
        self.evaluator = TopKEvaluator(config)
        # group masks for test-time metrics (engine.evaluator.group_masks)
        self.pop_mask = config["pop_mask"]
        self.warm_mask = config["warm_mask"]
        self.state = model.init_state()
        self._mask_cache = {}

    def _dense_mask(self, eval_data: EvalData) -> torch.Tensor:
        """(U_pad, n_pad/8) uint8 little-endian bit matrix of each user's
        train positives, n_pad the MASK_GROUP multiple above n_items, pad
        columns set. Built once per eval set on the host, in user slabs."""
        cached = self._mask_cache.get(id(eval_data))
        if cached is not None:
            return cached[1]
        U_pad = eval_data.users.shape[0]
        n_items = eval_data.n_items
        n_pad = -(-n_items // MASK_GROUP) * MASK_GROUP
        if U_pad * (n_pad // 8) > self._DENSE_MASK_BUDGET:
            raise NotImplementedError(
                f"packed mask of {U_pad} x {n_pad // 8} bytes exceeds the budget; "
                "the per-chunk scatter mask is not ported yet"
            )
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
        k_eff = min(max_k, model.n_items)
        B = self.eval_batch_size
        mask = self._dense_mask(eval_data)
        arts = model.eval_artifacts(self.state)
        out = []
        for lo in range(0, eval_data.users.shape[0], B):
            scores = model.scores_cached(self.state, eval_data.users[lo : lo + B], arts)
            _, top = grouped_topk(scores, k_eff, packed_mask=mask[lo : lo + B])
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
