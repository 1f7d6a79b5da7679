"""Dataset ingestion: ``<ds>.inter`` TSV → numpy index arrays.

Counterpart of ``genmmrec_tpu/data/dataset.py``: tab-separated interaction
file with columns ``userID``/``itemID``/``x_label`` (optional rating and
timestamp); ``n_users``/``n_items`` are ``max id + 1``; ``split()``
partitions on ``x_label`` ∈ {0: train, 1: valid, 2: test} and optionally
drops valid/test users unseen in train.

A tab-separated file is read by the port's native parser
(``genmmrec_tpu_torch/native``), any other by the ``csv`` module; both
give the same table. When the file is absent and
``synthetic_fallback`` is set, the same deterministic synthetic dataset as
the JAX package's is generated: the same numpy code and seed, so the two
packages see bit-identical tables.
"""

from __future__ import annotations

import csv
import os
import zlib
from dataclasses import dataclass
from logging import getLogger
from typing import Optional

import numpy as np

from genmmrec_tpu_torch import native


@dataclass
class InterTable:
    """Flat interaction table (host, numpy)."""

    users: np.ndarray  # (n,) int32
    items: np.ndarray  # (n,) int32
    n_users: int
    n_items: int
    ratings: Optional[np.ndarray] = None  # (n,) float32 or None
    times: Optional[np.ndarray] = None  # (n,) float64 or None

    def __len__(self) -> int:
        return len(self.users)

    def subset(self, keep: np.ndarray) -> "InterTable":
        return InterTable(
            users=self.users[keep],
            items=self.items[keep],
            n_users=self.n_users,
            n_items=self.n_items,
            ratings=self.ratings[keep] if self.ratings is not None else None,
            times=self.times[keep] if self.times is not None else None,
        )


def _number(x: str) -> float:
    try:
        return float(x)
    except ValueError:
        return float("nan")


def _read_inter_csv(path, sep, header, uid_field, iid_field, label_field, rating_field=None, time_field=None):
    """The ``csv`` route of ``RecDataset._load_inter``, with the native
    parser's rules: (users, items, labels, ratings or None, times or None)."""
    with open(path, "r", newline="", encoding="utf-8") as f:
        reader = csv.reader(f, delimiter=sep)
        next(reader, None)
        rows = [r for r in reader if r]
    col = {name: i for i, name in enumerate(header)}

    def column(name):
        i = col[name]
        return np.array([_number(r[i]) if i < len(r) else np.nan for r in rows], np.float64)

    u, it = column(uid_field), column(iid_field)
    keep = np.isfinite(u) & np.isfinite(it)
    keep[keep] = (u[keep] > -1) & (it[keep] > -1)
    labels = column(label_field)[keep]
    labels = np.where(np.isfinite(labels), labels, 0)
    ratings = column(rating_field)[keep].astype(np.float32) if rating_field else None
    times = column(time_field)[keep] if time_field else None
    as_i32 = lambda a: np.trunc(a).astype(np.int32)
    return as_i32(u[keep]), as_i32(it[keep]), as_i32(labels), ratings, times


class RecDataset:
    def __init__(self, config, table: Optional[InterTable] = None):
        self.config = config
        self.logger = getLogger()
        self.dataset_name = config["dataset"]
        self.uid_field = config["USER_ID_FIELD"]
        self.iid_field = config["ITEM_ID_FIELD"]
        self.splitting_label = config["inter_splitting_label"]

        if table is not None:
            self.table = table
            self.labels = None
            self.user_num = table.n_users
            self.item_num = table.n_items
            return

        self.dataset_path = os.path.abspath(
            os.path.join(config["data_path"] or "./data/", self.dataset_name)
        )
        inter_file = os.path.join(self.dataset_path, config["inter_file_name"] or "")
        if os.path.isfile(inter_file):
            self._load_inter(inter_file)
        elif config["synthetic_fallback"]:
            self.logger.warning(
                "Interaction file %s not found; generating deterministic "
                "synthetic dataset for %s.",
                inter_file,
                self.dataset_name,
            )
            self._generate_synthetic()
        else:
            raise ValueError(f"File {inter_file} not exist")

        self.user_num = int(self.table.users.max()) + 1 if len(self.table) else 0
        self.item_num = int(self.table.items.max()) + 1 if len(self.table) else 0
        self.table.n_users = self.user_num
        self.table.n_items = self.item_num

    def _load_inter(self, inter_file: str) -> None:
        """Read the ``.inter`` file: a tab-separated one by the native parser,
        any other separator by the ``csv`` module (``_read_inter_csv``). Both
        give the same table and labels: blank lines are no rows, a row with a
        negative or empty user or item id is dropped whole (its time too), an
        empty rating or time is NaN."""
        sep = self.config["field_separator"] or "\t"
        with open(inter_file, "r", newline="", encoding="utf-8") as f:
            header = next(csv.reader(f, delimiter=sep), [])
        missing = [c for c in (self.uid_field, self.iid_field, self.splitting_label) if c not in header]
        if missing:
            raise ValueError(f"File {inter_file} lost some required columns: {', '.join(missing)}.")
        rating_field = self.config["RATING_FIELD"] if self.config["RATING_FIELD"] in header else None
        time_field = self.config["TIME_FIELD"] if self.config["TIME_FIELD"] in header else None
        cols = (header, self.uid_field, self.iid_field, self.splitting_label, rating_field, time_field)
        if sep == "\t" and native.get_lib() is not None:
            users, items, labels, ratings, times = native.parse_inter_tsv(inter_file, *cols)
        else:
            if sep == "\t":
                self.logger.warning("no g++ for the native .inter parser; reading %s with csv", inter_file)
            users, items, labels, ratings, times = _read_inter_csv(inter_file, sep, *cols)
        self.table = InterTable(users=users, items=items, n_users=0, n_items=0, ratings=ratings, times=times)
        self.labels = labels

    def _generate_synthetic(self) -> None:
        """Zipf-like item popularity, log-normal user activity, 80/10/10
        per-user split; identical to the JAX package's generator."""
        cfg = self.config
        n_users = int(cfg["synthetic_n_users"] or 1000)
        n_items = int(cfg["synthetic_n_items"] or 500)
        n_inters = int(cfg["synthetic_n_inters"] or 10000)
        rng = np.random.default_rng(0xC0FFEE ^ zlib.crc32(self.dataset_name.encode()))

        act = rng.lognormal(0.0, 1.0, n_users)
        counts = np.maximum(3, (act / act.sum() * n_inters).astype(np.int64))
        counts = np.minimum(counts, min(n_items, 1000))
        pop = 1.0 / np.arange(1, n_items + 1) ** 0.8
        pop /= pop.sum()
        item_perm = rng.permutation(n_items)

        users_list, items_list, labels_list = [], [], []
        for u in range(n_users):
            c = int(min(counts[u], n_items))
            its = item_perm[rng.choice(n_items, size=c, replace=False, p=pop)].astype(np.int32)
            users_list.append(np.full(c, u, np.int32))
            items_list.append(its)
            lab = np.zeros(c, np.int32)
            if c >= 3:
                lab[-1] = 2  # test
                lab[-2] = 1  # valid
            labels_list.append(lab)
        users = np.concatenate(users_list)
        items = np.concatenate(items_list)
        labels = np.concatenate(labels_list)
        # every user/item id occurs at least once in train
        users[0], items[0] = 0, 0
        self.table = InterTable(
            users=np.concatenate([users, np.array([n_users - 1], np.int32)]),
            items=np.concatenate([items, np.array([n_items - 1], np.int32)]),
            n_users=n_users,
            n_items=n_items,
        )
        self.labels = np.concatenate([labels, np.array([0], np.int32)])
        # chronological surrogate: file order (per-user order is temporal)
        self.table.times = np.arange(len(self.table.users), dtype=np.float64)

    def split(self):
        """Return (train, valid, test) RecDatasets split on x_label."""
        if self.labels is None:
            raise ValueError("split() called on an already-split dataset")
        parts = [self.table.subset(self.labels == lab) for lab in range(3)]
        if self.config["filter_out_cod_start_users"]:
            train_users = np.zeros(self.user_num, bool)
            train_users[parts[0].users] = True
            for i in (1, 2):
                parts[i] = parts[i].subset(train_users[parts[i].users])
        return [self.copy(p) for p in parts]

    def copy(self, table: InterTable) -> "RecDataset":
        nxt = RecDataset(self.config, table)
        nxt.user_num = self.user_num
        nxt.item_num = self.item_num
        return nxt

    def get_user_num(self) -> int:
        return self.user_num

    def get_item_num(self) -> int:
        return self.item_num

    def __len__(self) -> int:
        return len(self.table)

    def __str__(self) -> str:
        inter_num = len(self.table)
        uni_u = len(np.unique(self.table.users))
        uni_i = len(np.unique(self.table.items))
        info = [str(self.dataset_name)]
        if uni_u:
            info.append(f"The number of users: {uni_u}")
            info.append(f"Average actions of users: {inter_num / uni_u}")
        if uni_i:
            info.append(f"The number of items: {uni_i}")
            info.append(f"Average actions of items: {inter_num / uni_i}")
        info.append(f"The number of inters: {inter_num}")
        if uni_u and uni_i:
            sparsity = 1 - inter_num / uni_u / uni_i
            info.append(f"The sparsity of the dataset: {sparsity * 100}%")
        return "\n".join(info)

    __repr__ = __str__
