"""ctypes bindings of the port's C++ host runtime (``genmmrec_native.cpp``).

Counterpart of ``genmmrec_tpu/native/__init__.py``. The library is built
with ``g++`` at first use, never at import, into ``build/native/`` at the
root of the checkout, under a name keyed by a hash of the source and the
flags (as ``ops/_build.py`` builds the CUDA kernels): a changed source
builds anew, an unchanged one is reused.

``get_lib`` returns None only when no ``g++`` is on ``PATH``; the callers
then log a warning and take their numpy route. A failed compile or load
raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "genmmrec_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build", "native")
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]


def library_path() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libgenmmrec_native_{h.hexdigest()[:16]}.so")


def build(compiler: str) -> str:
    """Compile the library if it is not built yet; returns its path."""
    out = library_path()
    if os.path.isfile(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([compiler, *FLAGS, SOURCE, "-o", tmp], capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"g++ failed ({proc.returncode}) on {SOURCE}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library with its argument types declared, or None when
    there is no ``g++`` to build it."""
    compiler = shutil.which("g++")
    if compiler is None:
        return None
    lib = ctypes.CDLL(build(compiler))
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    c = ctypes
    lib.tsv_count_rows.restype = c.c_int64
    lib.tsv_count_rows.argtypes = [c.c_char_p]
    lib.tsv_parse_inter.restype = c.c_int64
    lib.tsv_parse_inter.argtypes = [
        c.c_char_p, c.c_int, c.c_int, c.c_int, c.c_int, c.c_int,
        i32p, i32p, i32p, c.c_void_p, c.c_void_p, c.c_int64,
    ]
    lib.build_padded_history.restype = c.c_int64
    lib.build_padded_history.argtypes = [i32p, i32p, c.c_int64, c.c_int32, c.c_int32, i32p, i32p, c.c_int64]
    lib.max_row_count.restype = c.c_int64
    lib.max_row_count.argtypes = [i32p, c.c_int64, c.c_int32]
    lib.cooccur_topk.restype = None
    lib.cooccur_topk.argtypes = [i32p, i32p, c.c_int64, c.c_int32, c.c_int32, c.c_int32, i32p, f32p]
    return lib


def _required() -> ctypes.CDLL:
    lib = get_lib()
    if lib is None:
        raise RuntimeError("no g++ on PATH: the native library cannot be built")
    return lib


def parse_inter_tsv(
    path: str, header: list, uid_field: str, iid_field: str, label_field: str,
    rating_field: Optional[str] = None, time_field: Optional[str] = None,
):
    """The columns of a tab-separated ``.inter`` file with this header:
    (users, items, labels int32, ratings float32 or None, times float64 or
    None), each from the same kept rows. A row with a negative or empty
    user or item id is dropped; an empty rating or time is NaN."""
    lib = _required()
    cols = {name: i for i, name in enumerate(header)}
    missing = [c for c in (uid_field, iid_field, label_field) if c not in cols]
    if missing:
        raise ValueError(f"File {path} lost some required columns: {', '.join(missing)}.")
    n = lib.tsv_count_rows(path.encode())
    if n < 0:
        raise OSError(f"cannot open {path}")
    r_col = cols.get(rating_field, -1) if rating_field else -1
    t_col = cols.get(time_field, -1) if time_field else -1
    users, items, labels = (np.empty(n, np.int32) for _ in range(3))
    ratings = np.empty(n, np.float32) if r_col >= 0 else None
    times = np.empty(n, np.float64) if t_col >= 0 else None
    ptr = lambda a: None if a is None else a.ctypes.data_as(ctypes.c_void_p)
    got = lib.tsv_parse_inter(
        path.encode(), cols[uid_field], cols[iid_field], cols[label_field], r_col, t_col,
        users, items, labels, ptr(ratings), ptr(times), n,
    )
    if got < 0:
        raise OSError(f"cannot open {path}")
    cut = lambda a: None if a is None else a[:got].copy()
    return users[:got].copy(), items[:got].copy(), labels[:got].copy(), cut(ratings), cut(times)


def padded_history(ids: np.ndarray, vals: np.ndarray, n_rows: int, pad_value: int):
    """(n_rows, max_len) int32 rows of ``vals`` grouped by ``ids``, each
    sorted ascending and padded with ``pad_value`` (max_len at least 1), and
    each row's length (int32)."""
    lib = _required()
    ids = np.ascontiguousarray(ids, np.int32)
    vals = np.ascontiguousarray(vals, np.int32)
    if len(ids) and (int(ids.min()) < 0 or int(ids.max()) >= n_rows):
        raise ValueError(f"row ids must lie in [0, {n_rows})")
    max_len = max(1, int(lib.max_row_count(ids, len(ids), n_rows)))
    out = np.empty((n_rows, max_len), np.int32)
    lens = np.empty(n_rows, np.int32)
    lib.build_padded_history(ids, vals, len(ids), n_rows, pad_value, out, lens, max_len)
    return out, lens


def cooccur_topk(left: np.ndarray, right: np.ndarray, n_left: int, n_right: int, k: int):
    """Each left node's k left nodes of most shared right nodes: (nbrs
    (n_left, k) int32, counts (n_left, k) float32); a short row repeats its
    neighbours cyclically, an empty one is 0."""
    lib = _required()
    left = np.ascontiguousarray(left, np.int32)
    right = np.ascontiguousarray(right, np.int32)
    nbrs = np.zeros((n_left, k), np.int32)
    wts = np.zeros((n_left, k), np.float32)
    lib.cooccur_topk(left, right, len(left), n_left, n_right, k, nbrs, wts)
    return nbrs, wts
