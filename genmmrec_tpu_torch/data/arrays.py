"""Train/eval data as tensors on an explicit device.

Counterpart of ``genmmrec_tpu/data/arrays.py`` (``TrainData``,
``EvalData`` and their builders). The matrices are built once on the host
with numpy and moved to the device:

- ``TrainData``: flat interaction index arrays, a padded per-user history
  matrix (rows sorted, padded with ``n_items``) and the pool of train items
  that negatives are drawn from;
- ``EvalData``: unique eval users padded to a user-batch multiple, a padded
  ground-truth item matrix (``-1`` padding) and a padded train-positive
  matrix (``n_items`` padding) for masking seen items.

``sample_negatives`` draws one negative per interaction on the device.
"""

from __future__ import annotations

import dataclasses
from logging import getLogger
from typing import Optional

import numpy as np
import torch

from genmmrec_tpu_torch import native
from genmmrec_tpu_torch.data.dataset import RecDataset


def _pad_group_matrix(
    ids: np.ndarray, values: np.ndarray, n_rows: int, pad_value: int, sort_rows=False
):
    """Group ``values`` by ``ids`` into a dense (n_rows, max_len) matrix.
    Sorted rows come from the native library when it can be built."""
    if sort_rows:
        if native.get_lib() is not None:
            return native.padded_history(ids, values, n_rows, pad_value)
        getLogger().warning("no g++ for the native history build; grouping with numpy")
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
    item_pool: torch.Tensor  # (n_pool rounded up to 128,) int64: unique train items, cycled
    n_users: int
    n_items: int
    n_inter: int
    n_pool: int
    # per-interaction timestamps as float32 (the JAX field's type: a Unix
    # time rounds to a multiple of 128 s), or None when the table has none
    times: Optional[torch.Tensor] = None

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
    pool = np.unique(items)
    # cycled up to a multiple of 128, as in the JAX package: the draws index
    # only the first n_pool entries
    pool_padded = np.resize(pool, -(-len(pool) // 128) * 128)
    to = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
    return TrainData(
        users=to(users, torch.int64),
        items=to(items, torch.int64),
        hist=to(hist, torch.int64),
        hist_len=to(hist_len, torch.int32),
        item_pool=to(pool_padded, torch.int64),
        n_users=n_users,
        n_items=n_items,
        n_inter=len(users),
        n_pool=len(pool),
        times=None if train_ds.table.times is None else to(train_ds.table.times, torch.float32),
    )


def interaction_vectors(td: TrainData, users: torch.Tensor, cols=None) -> torch.Tensor:
    """(B, n_items) 0/1 rows of the users' train items. The history pads
    with ``n_items``: scatter into one spare column and drop it. ``cols``
    (an object with ``lo`` and ``hi``, ``parallel.mesh.ItemCols``) builds
    the columns ``[lo, hi)`` alone, (B, hi − lo): an item outside them goes
    to the spare column."""
    h = td.hist[users]
    if cols is None:
        x = torch.zeros(users.shape[0], td.n_items + 1, device=h.device)
        return x.scatter_(1, h, 1.0)[:, : td.n_items]
    w = cols.hi - cols.lo
    at = torch.where((h >= cols.lo) & (h < cols.hi), h - cols.lo, w)
    x = torch.zeros(users.shape[0], w + 1, device=h.device)
    return x.scatter_(1, at, 1.0)[:, :w]


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


def sample_negatives(
    users: torch.Tensor,
    hist: torch.Tensor,
    item_pool: torch.Tensor,
    n_pool: int,
    rounds: int = 4,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """One negative per user of ``users``, never one of the user's positives.

    Counterpart of the JAX package's ``sample_negatives``, on the device:

    1. ``rounds`` resampling passes: draw uniformly from the train item
       pool, redraw the rows whose candidate is in the user's history;
    2. an exact order-statistics fallback for rows that still collide: draw
       j ~ U[0, n_free) and binary-search the j-th pool item that is not in
       the user's sorted history, so dense users get an exactly uniform
       negative.

    The draws come from ``generator`` (on the users' device).
    """
    B = users.shape[0]
    dev = users.device
    user_hist = hist[users]  # (B, max_hist), rows sorted, padded with n_items

    def draw():
        return item_pool[torch.randint(0, n_pool, (B,), generator=generator, device=dev)]

    neg = draw()
    for _ in range(rounds):
        collide = (user_hist == neg[:, None]).any(dim=1)
        neg = torch.where(collide, draw(), neg)

    # the history pads with n_items, above every pool item
    valid_hist = user_hist <= item_pool.max()
    n_free = (n_pool - valid_hist.sum(dim=1)).clamp(min=1)
    j = (torch.rand(B, generator=generator, device=dev) * n_free).to(torch.int64)
    hist_masked = torch.where(valid_hist, user_hist, torch.iinfo(torch.int64).max)
    lo = torch.zeros(B, dtype=torch.int64, device=dev)
    hi = torch.full((B,), n_pool - 1, dtype=torch.int64, device=dev)
    for _ in range(int(np.ceil(np.log2(max(n_pool, 2)))) + 1):
        mid = (lo + hi) // 2
        # pool items up to pool[mid] that are not in the history
        free = mid + 1 - (hist_masked <= item_pool[mid][:, None]).sum(dim=1)
        pred = free > j
        hi = torch.where(pred, mid, hi)
        lo = torch.where(pred, lo, mid + 1)
    exact = item_pool[lo]
    collide = (user_hist == neg[:, None]).any(dim=1)
    return torch.where(collide, exact, neg)
