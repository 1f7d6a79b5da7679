"""Train/eval data as tensors on an explicit device.

Counterpart of ``genmmrec_tpu/data/arrays.py`` (``TrainData``,
``EvalData`` and their builders). The matrices are built once on the host
with numpy and moved to the device:

- ``TrainData``: flat interaction index arrays and a padded per-user
  history matrix (rows sorted, padded with ``n_items``);
- ``EvalData``: unique eval users padded to a user-batch multiple, a padded
  ground-truth item matrix (``-1`` padding) and a padded train-positive
  matrix (``n_items`` padding) for masking seen items.

Negative sampling comes with training and is not here yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from genmmrec_tpu_torch.data.dataset import RecDataset


def _pad_group_matrix(
    ids: np.ndarray, values: np.ndarray, n_rows: int, pad_value: int, sort_rows=False
):
    """Group ``values`` by ``ids`` into a dense (n_rows, max_len) matrix."""
    order = np.argsort(ids, kind="stable")
    ids_s, vals_s = ids[order], values[order]
    counts = np.bincount(ids_s, minlength=n_rows)
    max_len = int(counts.max()) if len(counts) and counts.max() > 0 else 1
    out = np.full((n_rows, max_len), pad_value, dtype=np.int32)
    starts = np.zeros(n_rows + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    pos = np.arange(len(ids_s)) - starts[ids_s]
    out[ids_s, pos] = vals_s
    if sort_rows:
        out = np.sort(out, axis=1)
    return out, counts.astype(np.int32)


@dataclasses.dataclass(frozen=True)
class TrainData:
    users: torch.Tensor  # (n_inter,) int64
    items: torch.Tensor  # (n_inter,) int64
    hist: torch.Tensor  # (n_users, max_hist) int64, rows sorted, padded with n_items
    hist_len: torch.Tensor  # (n_users,) int32
    n_users: int
    n_items: int
    n_inter: int

    @property
    def device(self) -> torch.device:
        return self.hist.device


@dataclasses.dataclass(frozen=True)
class EvalData:
    users: torch.Tensor  # (U_pad,) int64, padded with 0
    valid: torch.Tensor  # (U_pad,) bool, False on padded rows
    gt_items: torch.Tensor  # (U_pad, max_gt) int64, padded with -1
    gt_len: torch.Tensor  # (U_pad,) int32
    mask_items: torch.Tensor  # (U_pad, max_train) int64, padded with n_items
    mask_len: torch.Tensor  # (U_pad,) int32
    n_users_eval: int
    n_items: int


def build_train_data(train_ds: RecDataset, device) -> TrainData:
    users = np.asarray(train_ds.table.users, np.int32)
    items = np.asarray(train_ds.table.items, np.int32)
    n_users, n_items = train_ds.user_num, train_ds.item_num
    hist, hist_len = _pad_group_matrix(users, items, n_users, pad_value=n_items, sort_rows=True)
    to = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
    return TrainData(
        users=to(users, torch.int64),
        items=to(items, torch.int64),
        hist=to(hist, torch.int64),
        hist_len=to(hist_len, torch.int32),
        n_users=n_users,
        n_items=n_items,
        n_inter=len(users),
    )


def build_eval_data(eval_ds: RecDataset, train_ds: RecDataset, batch_size: int, device) -> EvalData:
    n_items = eval_ds.item_num
    e_users = np.asarray(eval_ds.table.users, np.int32)
    e_items = np.asarray(eval_ds.table.items, np.int32)
    uniq = np.unique(e_users)
    U = len(uniq)

    # compact row ids for grouping
    remap = np.zeros(eval_ds.user_num + 1, np.int64)
    remap[uniq] = np.arange(U)
    gt, gt_len = _pad_group_matrix(remap[e_users], e_items, U, pad_value=-1)

    t_users = np.asarray(train_ds.table.users, np.int32)
    t_items = np.asarray(train_ds.table.items, np.int32)
    keep = np.isin(t_users, uniq)
    mask_m, mask_len = _pad_group_matrix(remap[t_users[keep]], t_items[keep], U, pad_value=n_items)

    U_pad = -(-U // batch_size) * batch_size
    pad = U_pad - U

    def _pad_rows(a, fill):
        return np.concatenate([a, np.full((pad,) + a.shape[1:], fill, a.dtype)], axis=0)

    to = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
    return EvalData(
        users=to(_pad_rows(uniq.astype(np.int32), 0), torch.int64),
        valid=to(np.concatenate([np.ones(U, bool), np.zeros(pad, bool)]), torch.bool),
        gt_items=to(_pad_rows(gt, -1), torch.int64),
        gt_len=to(_pad_rows(np.maximum(gt_len, 1), 1), torch.int32),
        mask_items=to(_pad_rows(mask_m, n_items), torch.int64),
        mask_len=to(_pad_rows(mask_len, 0), torch.int32),
        n_users_eval=U,
        n_items=n_items,
    )
