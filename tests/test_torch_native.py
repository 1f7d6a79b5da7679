"""The port's native host runtime (``genmmrec_tpu_torch/native``) and the
``.inter`` reader's two routes against the JAX package, on the CPU: the
parse, the padded history and the co-occurrence top-k against
``genmmrec_tpu.native``; ``RecDataset`` by the native and the ``csv``
route against the JAX loader; a comma-separated file (which the JAX
native parser reads as no rows) and a row with a negative id (after which
the JAX loader's times no longer line up with its rows)."""

import os

import numpy as np
import pytest

from genmmrec_tpu import config as jcfg
from genmmrec_tpu import native as jnative
from genmmrec_tpu.data.dataset import RecDataset as JDataset
from genmmrec_tpu_torch import config as tcfg
from genmmrec_tpu_torch import native
from genmmrec_tpu_torch.data.arrays import _pad_group_matrix
from genmmrec_tpu_torch.data.dataset import RecDataset as TDataset
from genmmrec_tpu_torch.data.dataset import _read_inter_csv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADER = ["userID", "itemID", "rating", "timestamp", "x_label"]
FIELDS = ("userID", "itemID", "x_label")


def _inter_rows(seed, n=400, n_users=30, n_items=50):
    rng = np.random.default_rng(seed)
    return (
        rng.integers(0, n_users, n),
        rng.integers(0, n_items, n),
        rng.integers(1, 11, n) / 2.0,
        1_300_000_000 + rng.integers(0, 10**6, n),
        rng.integers(0, 3, n),
    )


def _write(path, rows, sep="\t", blank_every=0, header=HEADER):
    lines = [sep.join(header)]
    for j, r in enumerate(zip(*rows)):
        lines.append(sep.join(str(x) for x in r))
        if blank_every and j % blank_every == 0:
            lines.append("")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return str(path)


def test_library_is_built_under_build_native():
    lib = native.get_lib()
    assert lib is not None
    path = native.library_path()
    assert os.path.dirname(path) == os.path.join(REPO, "build", "native")
    assert os.path.basename(path).startswith("libgenmmrec_native_") and os.path.isfile(path)
    assert native.get_lib() is lib


@pytest.mark.parametrize("seed", [0, 1])
def test_parse_against_jax(tmp_path, seed):
    rows = _inter_rows(seed)
    path = _write(tmp_path / "x.inter", rows)
    ju, ji, jl, jr = jnative.parse_inter_tsv(path, HEADER, *FIELDS, "rating")
    tu, ti, tl, tr, tt = native.parse_inter_tsv(path, HEADER, *FIELDS, "rating", "timestamp")
    for a, b in ((tu, ju), (ti, ji), (tl, jl), (tr, jr)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tt, rows[3].astype(np.float64))


@pytest.mark.parametrize("pad", [50, -1])
def test_padded_history_against_jax_and_numpy(pad):
    u, i, *_ = _inter_rows(2)
    u[:5] = 7  # a long row, and users 28 and 29 absent
    u = np.where(u >= 28, 3, u)
    out, lens = native.padded_history(u, i, 30, pad)
    j_out, j_lens = jnative.padded_history(u, i, 30, pad)
    np.testing.assert_array_equal(out, j_out)
    np.testing.assert_array_equal(lens, j_lens)
    assert lens[28] == lens[29] == 0 and (out[28] == pad).all()
    if pad == 50:  # the numpy route's sorted rows, as build_train_data asks for them
        ref, ref_len = _pad_group_matrix(u, i, 30, pad)
        np.testing.assert_array_equal(out, np.sort(ref, axis=1))
        np.testing.assert_array_equal(lens, ref_len)
        via, via_len = _pad_group_matrix(u, i, 30, pad, sort_rows=True)
        np.testing.assert_array_equal(via, out)
        np.testing.assert_array_equal(via_len, lens)
    with pytest.raises(ValueError):
        native.padded_history(u, i, int(u.max()), pad)


@pytest.mark.parametrize("k", [3, 12])
def test_cooccur_topk_against_jax(k):
    """Counts as multisets and the neighbours strictly above each row's least
    count as sets (partial_sort orders equal counts freely)."""
    u, i, *_ = _inter_rows(3, n=300, n_users=40, n_items=25)
    u[-3:], i[-3:] = u[0], i[0]  # a repeated (user, item) row
    nb, w = native.cooccur_topk(u, i, 40, 25, k)
    j_nb, j_w = jnative.cooccur_topk(u, i, 40, 25, k)
    np.testing.assert_array_equal(np.sort(w, axis=1), np.sort(j_w, axis=1))
    for a, wa, b, wb in zip(nb, w, j_nb, j_w):
        assert set(a[wa > wa.min()]) == set(b[wb > wb.min()])
    assert (w[:, 0] > 0).all()


def _configs(tmp_path, sep="\t"):
    over = {"data_path": str(tmp_path), "synthetic_fallback": False, "field_separator": sep}
    return jcfg.Config("BPR", "tiny", dict(over)), tcfg.Config("BPR", "tiny", dict(over))


def _loads(path, sep="\t"):
    """The port's two readers on one file: [(users, items, labels, ratings, times)]."""
    cols = (HEADER, *FIELDS, "rating", "timestamp")
    return [native.parse_inter_tsv(path, *cols), _read_inter_csv(path, sep, *cols)]


def _equal(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_recdataset_both_routes_against_jax_loader(tmp_path):
    os.makedirs(tmp_path / "tiny")
    rows = _inter_rows(4)
    path = _write(tmp_path / "tiny" / "tiny.inter", rows, blank_every=37)
    jc, tc = _configs(tmp_path)
    jd, td = JDataset(jc), TDataset(tc)
    ref = (jd.table.users, jd.table.items, jd.labels, jd.table.ratings, jd.table.times)
    _equal((td.table.users, td.table.items, td.labels, td.table.ratings, td.table.times), ref)
    assert (td.user_num, td.item_num) == (jd.user_num, jd.item_num)
    for got in _loads(path):
        _equal(got, ref)
    for jp, tp in zip(jd.split(), td.split()):
        _equal((tp.table.users, tp.table.items, tp.table.times), (jp.table.users, jp.table.items, jp.table.times))


def test_comma_separated_file(tmp_path):
    """The native parsers split on tabs only and read a comma-separated file
    as no rows; the port's loader takes the csv route for it."""
    os.makedirs(tmp_path / "tiny")
    rows = _inter_rows(5)
    path = _write(tmp_path / "tiny" / "tiny.inter", rows, sep=",")
    _, tc = _configs(tmp_path, sep=",")
    td = TDataset(tc)
    want = [rows[0].astype(np.int32), rows[1].astype(np.int32), rows[4].astype(np.int32),
            rows[2].astype(np.float32), rows[3].astype(np.float64)]
    _equal((td.table.users, td.table.items, td.labels, td.table.ratings, td.table.times), want)
    assert len(jnative.parse_inter_tsv(path, HEADER, *FIELDS, "rating")[0]) == 0
    nat, by_csv = _loads(path, sep=",")
    assert all(len(a) == 0 for a in nat)  # the port's native parser too splits on tabs only
    _equal(by_csv, want)


def test_negative_id_keeps_times_aligned(tmp_path):
    """A row with a negative user id is dropped whole, its time too; the JAX
    loader keeps every row's time."""
    os.makedirs(tmp_path / "tiny")
    rows = [np.array(c) for c in ([0, -1, 2], [1, 2, 3], [5.0, 4.0, 3.0], [100, 200, 300], [0, 1, 2])]
    path = _write(tmp_path / "tiny" / "tiny.inter", rows)
    jc, tc = _configs(tmp_path)
    jd, td = JDataset(jc), TDataset(tc)
    keep = np.array([0, 2])
    want = (rows[0][keep].astype(np.int32), rows[1][keep].astype(np.int32), rows[4][keep].astype(np.int32),
            rows[2][keep].astype(np.float32), rows[3][keep].astype(np.float64))
    _equal((td.table.users, td.table.items, td.labels, td.table.ratings, td.table.times), want)
    for got in _loads(path):
        _equal(got, want)
    np.testing.assert_array_equal(jd.table.users, want[0])
    assert len(jd.table.times) == 3 != len(jd.table.users)


def test_empty_fields(tmp_path):
    """An empty rating or time is NaN and an empty id drops its row, on both routes."""
    os.makedirs(tmp_path / "tiny")
    with open(tmp_path / "tiny" / "tiny.inter", "w") as f:
        f.write("userID\titemID\trating\ttimestamp\tx_label\n0\t1\t\t100\t0\n\t2\t3\t4\t1\n2\t3\t1\t\t\n")
    _, tc = _configs(tmp_path)
    (a, b) = _loads(str(tmp_path / "tiny" / "tiny.inter"))
    _equal(a, b)
    np.testing.assert_array_equal(a[0], [0, 2])
    np.testing.assert_array_equal(a[2], [0, 0])
    assert np.isnan(a[3][0]) and np.isnan(a[4][1])
