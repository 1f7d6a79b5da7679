"""Full-catalog top-K evaluation (counterpart of
``genmmrec_tpu/engine/evaluator.py``).

Recall/Recall2/NDCG/Precision/MAP at every configured k, plus at test time
the Pop/Niche item-group metrics, Cold/Warm user-group metrics,
Coverage@k, two Gini@k variants and Tail%@k, computed with tensors on the
top-k's device; one host transfer brings back all scalars. Also the
popular-item and warm-user masks that define the groups.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from genmmrec_tpu_torch.data.arrays import EvalData
from genmmrec_tpu_torch.engine import metrics as M
from genmmrec_tpu_torch.utils.misc import get_local_time

_CANON = {m.lower(): m for m in ["Recall", "Recall2", "Precision", "NDCG", "MAP"]}


def group_masks(train_ds, device):
    """(pop_mask, warm_mask): popular items are the top 20% of the train
    items by count; warm users have more than 5 train interactions."""
    item_counts = np.bincount(train_ds.table.items, minlength=train_ds.item_num)
    unique_items = np.argsort(-item_counts, kind="stable")
    unique_items = unique_items[item_counts[unique_items] > 0]
    num_pop = int(len(unique_items) * 0.2)
    pop_mask = np.zeros(train_ds.item_num, bool)
    pop_mask[unique_items[:num_pop]] = True
    user_counts = np.bincount(train_ds.table.users, minlength=train_ds.user_num)
    warm_mask = user_counts > 5
    return torch.as_tensor(pop_mask, device=device), torch.as_tensor(warm_mask, device=device)


def _chunked_hits(topk: torch.Tensor, gt: torch.Tensor, chunk: int = 2048) -> torch.Tensor:
    """(U, K) bool: whether each recommended item is in the row's gt set."""
    return torch.cat(
        [
            (t[:, :, None] == g[:, None, :]).any(dim=-1)
            for t, g in zip(topk.split(chunk), gt.split(chunk))
        ]
    )


class TopKEvaluator:
    def __init__(self, config):
        self.config = config
        metrics = config["metrics"]
        if isinstance(metrics, str):
            metrics = [metrics]
        for m in metrics:
            if m.lower() not in M.metrics_dict:
                raise ValueError(f"There is no user grouped topk metric named {m}!")
        self.metrics = [m.lower() for m in metrics]
        topk = config["topk"]
        self.topk = [topk] if isinstance(topk, int) else list(topk)
        if any(k <= 0 for k in self.topk):
            raise ValueError("topk must be positive")
        self.max_k = max(self.topk)
        self.save_recom_result = bool(config["save_recommended_topk"])

    def evaluate(
        self,
        topk_index: torch.Tensor,  # (U_pad, max_k) int64, -1 = no item
        eval_data: EvalData,
        pop_mask: Optional[torch.Tensor] = None,  # (n_items,) bool
        warm_mask: Optional[torch.Tensor] = None,  # (n_users,) bool
        is_test: bool = False,
        idx: int = 0,
    ) -> Dict[str, float]:
        out = self._metrics(topk_index, eval_data, pop_mask, warm_mask, is_test)
        keys = list(out.keys())
        vals = torch.stack([out[k].to(torch.float32) for k in keys]).cpu().numpy()
        result = {k: round(float(v), 4) for k, v in zip(keys, vals)}
        if self.save_recom_result and is_test:
            self._save_topk(topk_index, eval_data, idx)
        return result

    def _metrics(self, topk_index, ed: EvalData, pop_mask, warm_mask, is_test):
        n_items = ed.n_items
        w = ed.valid.to(torch.float32)
        hits = _chunked_hits(topk_index, ed.gt_items)
        out = {}

        def add_block(prefix, h, plen, weights, canon=False):
            for m in self.metrics:
                vals = M.metrics_dict[m](h, plen, weights)
                name = _CANON[m] if canon else m
                for k in self.topk:
                    out[f"{prefix}{name}@{k}"] = vals[k - 1]

        add_block("", hits, ed.gt_len, w)

        if is_test and pop_mask is not None:
            gt_valid = ed.gt_items >= 0
            gt_is_pop = gt_valid & pop_mask[ed.gt_items.clamp(0, n_items - 1)]
            for prefix, sel in (("Pop_", gt_is_pop), ("Niche_", gt_valid & ~gt_is_pop)):
                sub_gt = torch.where(sel, ed.gt_items, -1)
                sub_len = sel.sum(dim=1)
                sub_w = w * (sub_len > 0)
                sub_hits = _chunked_hits(topk_index, sub_gt)
                add_block(prefix, sub_hits, torch.clamp(sub_len, min=1), sub_w, canon=True)

        if is_test and warm_mask is not None:
            is_warm = warm_mask[ed.users]
            add_block("Cold_", hits, ed.gt_len, w * (~is_warm), canon=True)
            add_block("Warm_", hits, ed.gt_len, w * is_warm, canon=True)

        if is_test:
            for k in self.topk:
                top = topk_index[:, :k]
                keep = ed.valid[:, None] & (top >= 0)
                counts = torch.bincount(top[keep], minlength=n_items)[:n_items].to(torch.float32)
                n_active = (counts > 0).sum().to(torch.float32)
                out[f"Coverage@{k}"] = n_active / n_items
                out[f"Gini@{k}"] = M.gini_index(counts)
                out[f"Gini2@{k}"] = M.gini_trapz(counts, n_active)
                out[f"Coverage2@{k}"] = n_active / n_items
                if pop_mask is not None:
                    total = torch.clamp(counts.sum(), min=1.0)
                    out[f"Tail%@{k}"] = (counts * (~pop_mask)).sum() / total
        return out

    def _save_topk(self, topk_index, eval_data: EvalData, idx: int) -> None:
        dir_name = os.path.abspath(self.config["recommend_topk"] or "recommend_topk/")
        os.makedirs(dir_name, exist_ok=True)
        path = os.path.join(
            dir_name,
            f"{self.config['model']}-{self.config['dataset']}-idx{idx}"
            f"-top{self.max_k}-{get_local_time()}.csv",
        )
        U = eval_data.n_users_eval
        arr = topk_index[:U].cpu().numpy()
        users = eval_data.users[:U].cpu().numpy()
        header = "id\t" + "\t".join(f"top_{i}" for i in range(arr.shape[1]))
        np.savetxt(
            path,
            np.concatenate([users[:, None], arr], axis=1),
            fmt="%d",
            delimiter="\t",
            header=header,
            comments="",
        )

    def __str__(self) -> str:
        return (
            "The TopK Evaluator Info:\n\tMetrics:["
            + ", ".join(_CANON[m] for m in self.metrics)
            + "], TopK:["
            + ", ".join(map(str, self.topk))
            + "]"
        )
