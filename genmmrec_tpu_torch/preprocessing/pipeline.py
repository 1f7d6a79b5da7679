"""Offline preprocessing: raw ratings and meta → the framework's inputs.

Counterpart of ``genmmrec_tpu/preprocessing/pipeline.py``, on numpy and the
standard library alone (no pandas). A table is a dict of equal-length
numpy columns: int64, float64 or bool, or object columns of strings (or
other Python values) with NaN where a cell is missing. Files are read and
written with pandas' rules, so that the files are the same byte for byte:

- a column read from a file is int64 when every cell is an integer, else
  float64 when every cell is a number or missing (pandas' missing-value
  markers: an empty cell, ``NA``, ``nan``, ...), else strings;
- a column is written as pandas writes it: integers as digits, floats by
  numpy's shortest repr (``5.0``, ``1e+16``), missing cells empty, other
  values by ``str``, quoted by the ``csv`` module's minimal rule.

The steps, as in the reference notebooks:

- ``kcore_filter`` / ``rating2inter``: drop rows missing a user, item or
  time, then exact (user, item, time) repeats, then repeated (user, item)
  pairs (the first row stays), then users and items below the floor until
  none is left; dense ids in order of first appearance; labels 0/1/2 at the
  0.8 and 0.9 quantiles of the timestamps (``np.quantile``).
- ``per_user_split``: a seeded permutation of the rows, a stable sort by
  user, each user's last rows valid and test (one each under 10 rows, else
  10% + 10%).
- ``reindex_meta``: meta ``asin`` → dense itemID, unmapped rows dropped,
  sorted by itemID.
- ``encode_text_features``: title + brand + first category chain +
  description → a local ``transformers`` checkpoint when one is cached
  (never downloaded), else the deterministic hashing encoder.
- ``build_user_graph_dict``: each user's top-200 users by shared train
  items. The only step on the accelerator: the counts are dense GEMMs over
  blocks of users on ``device`` and the top-k is K3
  (``ops/graph.py`` ``cooccurrence_topk``).
"""

from __future__ import annotations

import ast
import csv
import gzip
import json
import os
import zlib
from logging import getLogger
from typing import Dict, Optional

import numpy as np

# pandas' default markers of a missing cell
NA_VALUES = frozenset([
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND", "1.#QNAN",
    "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
])


# ----------------------------------------------------------------------
# tables and their files
def _typed(cells: list) -> np.ndarray:
    """A column of strings typed as pandas' ``read_csv`` types it."""
    arr = np.array(cells, dtype=str) if cells else np.zeros(0, str)
    na = np.isin(arr, sorted(NA_VALUES.intersection(cells)))
    if not na.any():
        try:
            return arr.astype(np.int64)
        except (ValueError, OverflowError):
            pass
    try:
        return np.where(na, "nan", arr).astype(np.float64)
    except (ValueError, OverflowError):
        out = np.array(cells, dtype=object)
        out[na] = np.nan
        return out


def read_table(path: str, sep: str = ",", names: Optional[list] = None) -> Dict[str, np.ndarray]:
    """A delimited file as typed columns: the first line is the header
    unless ``names`` are given. Blank lines are skipped; a short row's last
    cells are missing."""
    with open(path, "r", newline="", encoding="utf-8") as f:
        rows = [r for r in csv.reader(f, delimiter=sep) if r]
    if names is None:
        names, rows = rows[0], rows[1:]
    width = len(names)
    rows = [r if len(r) == width else (r + [""] * width)[:width] for r in rows]
    cols = list(zip(*rows)) if rows else [() for _ in names]
    return {name: _typed(list(c)) for name, c in zip(names, cols)}


def _isna(v) -> bool:
    return v is None or (isinstance(v, float) and v != v)


def _cells(col: np.ndarray) -> list:
    if col.dtype == object:
        return ["" if _isna(v) else v if isinstance(v, str) else str(v) for v in col]
    out = col.astype(str)
    if col.dtype.kind == "f":
        out[np.isnan(col)] = ""
    return out.tolist()


def write_table(path: str, table: Dict[str, np.ndarray], sep: str = ",") -> None:
    """Typed columns as pandas' ``to_csv(sep=sep, index=False)`` writes them."""
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, delimiter=sep, lineterminator="\n", quoting=csv.QUOTE_MINIMAL)
        w.writerow(list(table))
        w.writerows(zip(*(_cells(c) for c in table.values())))


def _records_column(values: list) -> np.ndarray:
    """A column of records' values (None where a record lacks the key), to
    be written as ``DataFrame.from_records`` would write it."""
    present = [v for v in values if not _isna(v)]
    numbers = present and all(isinstance(v, (int, float)) and not isinstance(v, bool) for v in present)
    if numbers and (len(present) < len(values) or not all(isinstance(v, int) for v in present)):
        # a float column: an integer among floats or missing cells is written as 3.0
        return np.array([np.nan if _isna(v) else float(v) for v in values], np.float64)
    out = np.empty(len(values), object)
    for j, v in enumerate(values):
        out[j] = np.nan if v is None else v
    return out


def _take(table: Dict[str, np.ndarray], idx) -> Dict[str, np.ndarray]:
    return {k: v[idx] for k, v in table.items()}


def _codes(col: np.ndarray) -> np.ndarray:
    """Dense codes of a column's values (none missing) in order of first
    appearance."""
    if col.dtype == object:
        if set(map(type, col.tolist())) != {str}:
            seen: dict = {}
            return np.fromiter((seen.setdefault(v, len(seen)) for v in col.tolist()), np.int64, len(col))
        col = col.astype(str)
    _, first, inv = np.unique(col, return_index=True, return_inverse=True)
    rank = np.empty(len(first), np.int64)
    rank[np.argsort(first)] = np.arange(len(first))
    return rank[inv.reshape(-1)]


def _first_rows(*codes: np.ndarray) -> np.ndarray:
    """Indices, ascending, of the first row of each distinct tuple of codes."""
    key = np.zeros(len(codes[0]), np.int64)
    for c in codes:
        _, key = np.unique(key * (int(c.max(initial=0)) + 1) + c, return_inverse=True)
    _, first = np.unique(key, return_index=True)
    return np.sort(first)


def _missing(col: np.ndarray) -> np.ndarray:
    if col.dtype.kind == "f":
        return np.isnan(col)
    if col.dtype == object:  # a missing cell is NaN, the one value unequal to itself
        return np.asarray(col != col, bool)
    return np.zeros(len(col), bool)


# ----------------------------------------------------------------------
def _kcore_rows(u: np.ndarray, i: np.ndarray, min_u: int, min_i: int) -> np.ndarray:
    """Indices, ascending, of the rows that stay in the k-core of the (user,
    item) code pairs: the first row of each pair, then no user with fewer
    than ``min_u`` rows and no item with fewer than ``min_i``."""
    keep = _first_rows(u, i)
    u, i = u[keep], i[keep]
    while True:
        bad = (np.bincount(u)[u] < min_u) | (np.bincount(i)[i] < min_i)
        if not bad.any():
            return keep
        keep, u, i = keep[~bad], u[~bad], i[~bad]


def kcore_filter(table: Dict[str, np.ndarray], uid: str = "userID", iid: str = "itemID",
                 min_u: int = 5, min_i: int = 5) -> Dict[str, np.ndarray]:
    """Iterative k-core (``0rating2inter.ipynb`` filter_by_k_core): rows
    missing a user or item go, then repeated (user, item) pairs (the first
    stays), then every user with fewer than ``min_u`` rows and every item
    with fewer than ``min_i``, until none is left."""
    table = _take(table, ~(_missing(table[uid]) | _missing(table[iid])))
    return _take(table, _kcore_rows(_codes(table[uid]), _codes(table[iid]), min_u, min_i))


def _dense_ids(col: np.ndarray, codes: np.ndarray):
    """(dense ids in order of first appearance, the values in that order),
    from any codes of the column's values."""
    dense = _codes(codes)
    _, first = np.unique(dense, return_index=True)
    return dense, col[np.sort(first)]


def rating2inter(ratings_csv: str, out_dir: str, dataset: str, min_u: int = 5, min_i: int = 5,
                 splitting=(0.8, 0.1, 0.1)) -> str:
    """Raw ratings CSV (user, item, rating, timestamp; no header) → the
    k-core filtered, reindexed, time-split ``<dataset>-indexed.inter`` and
    the ``u_id_mapping.csv`` / ``i_id_mapping.csv`` files."""
    t = read_table(ratings_csv, ",", ["userID", "itemID", "rating", "timestamp"])
    t = _take(t, ~(_missing(t["userID"]) | _missing(t["itemID"]) | _missing(t["timestamp"])))
    u, i = _codes(t["userID"]), _codes(t["itemID"])
    keep = _first_rows(u, i, _codes(t["timestamp"]))
    keep = keep[_kcore_rows(u[keep], i[keep], min_u, min_i)]
    t = _take(t, keep)
    u, u_keys = _dense_ids(t["userID"], u[keep])
    i, i_keys = _dense_ids(t["itemID"], i[keep])

    os.makedirs(out_dir, exist_ok=True)
    write_table(os.path.join(out_dir, "u_id_mapping.csv"),
                {"user_id": u_keys, "userID": np.arange(len(u_keys), dtype=np.int64)}, "\t")
    write_table(os.path.join(out_dir, "i_id_mapping.csv"),
                {"asin": i_keys, "itemID": np.arange(len(i_keys), dtype=np.int64)}, "\t")

    ratios = np.array([r for r in splitting if r > 0], dtype=np.float64)
    ratios = ratios / ratios.sum()
    ts = t["timestamp"]
    qs = np.quantile(ts, np.cumsum(ratios)[:-1])
    label = np.zeros(len(ts), np.int64)
    label[ts >= qs[0]] = 1
    label[ts >= qs[1]] = 2
    out = os.path.join(out_dir, f"{dataset}-indexed.inter")
    write_table(out, {"userID": u, "itemID": i, "rating": t["rating"], "timestamp": ts, "x_label": label}, "\t")
    return out


# ----------------------------------------------------------------------
def per_user_split(inter_file: str, out_file: Optional[str] = None, seed: int = 999) -> str:
    """Global-time labels → per-user 80/10/10 labels (``1splitting.ipynb``):
    shuffle, stable sort by user, each user's last rows valid and test (one
    each when the user has fewer than 10, else 10% + 10%)."""
    t = read_table(inter_file, "\t")
    rng = np.random.default_rng(seed)
    t = _take(t, rng.permutation(len(t["userID"])))
    t = _take(t, np.argsort(t["userID"], kind="stable"))
    _, counts = np.unique(t["userID"], return_counts=True)
    labels = np.zeros(len(t["userID"]), np.int64)
    pos = 0
    for n in counts.tolist():
        if n < 10:
            n_val, n_test = 1, 1
        else:
            vt = int(n * 0.2)
            n_val = vt // 2
            n_test = vt - n_val
        labels[pos + n - n_val - n_test : pos + n - n_test] = 1
        labels[pos + n - n_test : pos + n] = 2
        pos += n
    t["x_label"] = labels
    out_file = out_file or inter_file[: -len(".inter")] + "-v4.inter"
    write_table(out_file, t, "\t")
    return out_file


# ----------------------------------------------------------------------
def _read_meta(meta_file: str) -> Dict[str, np.ndarray]:
    if not meta_file.endswith((".json.gz", ".json")):
        return read_table(meta_file, ",")
    opener = gzip.open if meta_file.endswith(".gz") else open
    records = []
    with opener(meta_file, "rt") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(ast.literal_eval(line))
            except (ValueError, SyntaxError):
                records.append(json.loads(line))
    names = list(dict.fromkeys(k for r in records for k in r))
    return {k: _records_column([r.get(k) for r in records]) for k in names}


def reindex_meta(meta_file: str, i_mapping_csv: str, out_csv: str) -> Dict[str, np.ndarray]:
    """Map meta ``asin`` to dense itemIDs, drop unmapped rows, sort by
    itemID and write the CSV (``2reindex-feat.ipynb``). Reads ``.json.gz`` /
    ``.json`` (one record a line) and ``.csv`` meta files."""
    meta = _read_meta(meta_file)
    mapping = read_table(i_mapping_csv, "\t")
    to_id = dict(zip(mapping["asin"].tolist(), mapping["itemID"].tolist()))
    ids = np.array([to_id.get(a, -1) for a in meta["asin"].tolist()], np.int64)
    keep = np.flatnonzero(ids >= 0)
    keep = keep[np.argsort(ids[keep], kind="stable")]
    meta = {"itemID": ids[keep], **{k: v[keep] for k, v in meta.items() if k != "itemID"}}
    write_table(out_csv, meta, ",")
    return meta


# ----------------------------------------------------------------------
def _hashing_encoder(sentences, dim: int = 384, seed: int = 0) -> np.ndarray:
    """Deterministic offline encoder: token feature hashing (crc32, signed
    by a bit of the hash) + tf weighting, L2-normalized."""
    out = np.zeros((len(sentences), dim), np.float32)
    for i, sen in enumerate(sentences):
        for tok in sen.lower().split():
            h = zlib.crc32(f"{tok}\x00{seed}".encode())
            out[i, h % dim] += 1.0 if (h >> 16) & 1 else -1.0
    norms = np.linalg.norm(out, axis=1, keepdims=True)
    return out / np.maximum(norms, 1e-12)


def _meta_sentences(meta: Dict[str, np.ndarray]) -> list:
    """title + brand + first category chain + description (``3feat-encoder``).
    A missing cell reads ``nan`` and a missing column ``" "``, as the
    reference's pandas rows give them."""
    n = len(next(iter(meta.values()))) if meta else 0
    get = lambda name, r: meta[name][r] if name in meta else " "
    sentences = []
    for r in range(n):
        sen = str(get("title", r) or " ") + " " + str(get("brand", r) or " ") + " "
        cates = meta["categories"][r] if "categories" in meta else None
        if isinstance(cates, str):
            try:
                cates = ast.literal_eval(cates)
            except (ValueError, SyntaxError):
                cates = None
        if isinstance(cates, list) and cates and isinstance(cates[0], list):
            sen += " ".join(str(c) for c in cates[0]) + " "
        sen += str(get("description", r) or " ")
        sentences.append(sen.replace("\n", " "))
    return sentences


def _cached_checkpoint(model_name: str) -> bool:
    """Whether ``model_name`` is a local directory or has a snapshot in the
    Hugging Face hub cache (``HF_HUB_CACHE``, ``HF_HOME``/hub or
    ``~/.cache/huggingface/hub``)."""
    if os.path.isdir(model_name):
        return True
    hub = os.environ.get("HF_HUB_CACHE") or os.path.join(
        os.environ.get("HF_HOME") or os.path.join(os.path.expanduser("~"), ".cache", "huggingface"), "hub"
    )
    return os.path.isdir(os.path.join(hub, "models--" + model_name.replace("/", "--"), "snapshots"))


def _transformer_features(sentences, model_name: str) -> np.ndarray:
    """Mean-pooled last hidden states of a locally cached checkpoint (the
    MiniLM recipe); raises when none is cached or ``transformers`` is
    absent. Never downloads: the hub is put offline before the import."""
    if not _cached_checkpoint(model_name):
        raise FileNotFoundError(f"no cached checkpoint of {model_name}")
    os.environ.setdefault("HF_HUB_OFFLINE", "1")
    os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")
    import torch
    from transformers import AutoModel, AutoTokenizer

    tok = AutoTokenizer.from_pretrained(model_name, local_files_only=True)
    mdl = AutoModel.from_pretrained(model_name, local_files_only=True)
    mdl.eval()
    chunks = []
    with torch.no_grad():
        for s in range(0, len(sentences), 64):
            batch = tok(sentences[s : s + 64], padding=True, truncation=True, max_length=256, return_tensors="pt")
            hidden = mdl(**batch).last_hidden_state
            mask = batch["attention_mask"].unsqueeze(-1).float()
            emb = (hidden * mask).sum(1) / mask.sum(1).clamp(min=1e-9)
            chunks.append(torch.nn.functional.normalize(emb, dim=1).numpy())
    return np.concatenate(chunks, axis=0).astype(np.float32)


def encode_text_features(meta_csv: str, out_npy: str,
                         model_name: str = "sentence-transformers/all-MiniLM-L6-v2") -> np.ndarray:
    """Encode each item's text into ``text_feat.npy``, ordered by itemID."""
    meta = read_table(meta_csv, ",")
    meta = _take(meta, np.argsort(meta["itemID"], kind="stable"))
    ids = meta["itemID"]
    assert ids[-1] == len(ids) - 1, "meta must cover a dense 0..n-1 itemID range"
    sentences = _meta_sentences(meta)
    try:
        feats = _transformer_features(sentences, model_name)
        getLogger().info("encode_text_features: %d items by the local checkpoint %s", len(ids), model_name)
    except (FileNotFoundError, ImportError) as e:  # no cached checkpoint, or no transformers
        feats = _hashing_encoder(sentences)
        getLogger().info("encode_text_features: %d items by the hashing encoder (%s: %s)",
                         len(ids), type(e).__name__, e)
    np.save(out_npy, feats)
    return feats


# ----------------------------------------------------------------------
def user_graph_dict(users, items, n_users: int, n_items: int, top_k: int = 200, device="cuda") -> Dict[int, list]:
    """Each user's ``[neighbours, counts]``: the top ``min(top_k, n_users -
    1)`` other users by shared items (a user's repeated rows count once
    each), cut to counts above 0; counts descending, ties to the lower id."""
    import torch

    from genmmrec_tpu_torch.ops.graph import cooccurrence_topk

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but torch finds no CUDA device; pass device='cpu'")
    users = np.asarray(users, np.int64)
    if len(users) and (users.min() < 0 or users.max() >= n_users):
        raise ValueError(f"user ids must lie in [0, {n_users})")
    k = min(top_k, n_users - 1)
    if k <= 0:
        return {u: [[], []] for u in range(n_users)}
    nbrs, wts = cooccurrence_topk(users, items, n_users, n_items, k, device, repeats=True)
    nbrs, wts = nbrs.cpu().numpy(), wts.cpu().numpy()
    n_pos = np.isfinite(wts).sum(axis=1).tolist()
    return {u: [nbrs[u, :m].tolist(), wts[u, :m].tolist()] for u, m in enumerate(n_pos)}


def build_user_graph_dict(inter_file: str, n_users: Optional[int] = None, top_k: int = 200,
                          uid: str = "userID", iid: str = "itemID", device="cuda") -> Dict[int, list]:
    """DualGNN's user co-occurrence lists (``dualgnn-gen-u-u-matrix.py``)
    from the train rows (``x_label == 0``) of an ``.inter`` file, on
    ``device``: ``n_users`` defaults to the number of distinct users of the
    whole file, ``n_items`` is the largest item id + 1."""
    t = read_table(inter_file, "\t")
    if n_users is None:
        n_users = len(np.unique(t[uid]))
    train = t["x_label"] == 0
    n_items = int(t[iid].max()) + 1
    return user_graph_dict(t[uid][train], t[iid][train], n_users, n_items, top_k, device)


def save_user_graph_dict(inter_file: str, out_npy: str, top_k: int = 200, device="cuda") -> str:
    d = build_user_graph_dict(inter_file, top_k=top_k, device=device)
    np.save(out_npy, d, allow_pickle=True)
    return out_npy
