"""What the H100 designs of K1 and K3 keep in Python, on the CPU.

K1's list of long rows (``long_row_plan``, carried by every sorted graph) on
a ragged graph. K3's selection, mirrored step by step in PyTorch
(``grouped_topk_selection_plain``: thread maxima, threshold, candidates,
radix select on overflow), against ``grouped_topk_plain`` and
``jax.lax.top_k`` on seeded inputs and on adversarial rows: indices equal
exactly, values equal where finite. The order-preserving key both top-k
kernels compare by.
"""

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from genmmrec_tpu_torch.ops import graph as tgraph
from genmmrec_tpu_torch.ops import segment
from genmmrec_tpu_torch.ops.topk import (
    _K3_CAP,
    grouped_topk_plain,
    grouped_topk_selection_plain,
    order_key,
)

L = segment.LONG_ROW


def _ragged_graph(seed=0):
    """3,000 x 700: bands of empty rows at the start, in the middle and at
    the end, one row of 5,000 edges, rows of exactly L and L + 1 edges."""
    rng = np.random.default_rng(seed)
    n_rows, n_cols = 3000, 700
    live = np.concatenate([np.arange(40, 1200), np.arange(1500, 2900)])
    rows = np.concatenate([
        rng.choice(live[(live != 1777) & (live != 50) & (live != 51)], 9000),
        np.full(5000, 1777), np.full(L, 50), np.full(L + 1, 51),
    ])
    rows = np.sort(rows)
    cols = rng.integers(0, n_cols, rows.shape[0])
    vals = rng.integers(-2, 3, rows.shape[0]).astype(np.float32)
    g = tgraph.sorted_graph(torch.as_tensor(rows), torch.as_tensor(cols), torch.as_tensor(vals), n_rows, n_cols)
    return g, rows, cols


def _long_ids(ids, n_rows):
    return np.flatnonzero(np.bincount(ids, minlength=n_rows) > L)


def test_long_row_plan_lists_exactly_the_rows_over_the_threshold():
    g, rows, _ = _ragged_graph()
    plan = g.long_rows.numpy()
    want = _long_ids(rows, g.n_rows)
    assert 51 in want and 1777 in want and 50 not in want
    assert plan.dtype == np.int32 and plan.shape == (g.nnz // (L + 1) + 1,)
    np.testing.assert_array_equal(plan[: len(want)], want)
    assert (plan[len(want):] == -1).all() and plan[-1] == -1


def test_long_row_plan_of_the_transposed_graph_is_its_own():
    g, _, cols = _ragged_graph()
    # a column of many edges: a long row of the transpose only
    t = g.transposed()
    want = _long_ids(cols, g.n_cols)
    assert len(want) == 0  # 14,129 edges over 700 columns: about 20 each
    assert (t.long_rows.numpy() == -1).all()
    cols2 = cols.copy()
    cols2[:300] = 7
    g2 = tgraph.sorted_graph(g.rows, torch.as_tensor(cols2), g.vals, g.n_rows, g.n_cols)
    t2 = g2.transposed()
    np.testing.assert_array_equal(t2.long_rows.numpy()[:1], [7])
    assert (t2.long_rows.numpy()[1:] == -1).all()
    assert t2.long_rows.shape == g2.long_rows.shape  # the same edge count bounds both
    assert g2.transposed().long_rows is t2.long_rows  # kept with the structure


def test_a_rebuilt_graph_gets_a_fresh_plan_and_a_revalued_one_shares_it():
    import dataclasses

    g, rows, cols = _ragged_graph()
    moved = np.sort(np.where(rows == 1777, 2000, rows))
    g2 = tgraph.sorted_graph(torch.as_tensor(moved), g.cols, g.vals, g.n_rows, g.n_cols)
    assert 2000 in g2.long_rows.numpy() and 1777 not in g2.long_rows.numpy()
    assert 1777 in g.long_rows.numpy()
    dropped = dataclasses.replace(g, vals=g.vals * 0.5)
    assert dropped.long_rows is g.long_rows
    assert g.to("cpu").long_rows.equal(g.long_rows)


@pytest.mark.parametrize("lengths", [[], [0, 0, 0], [L, L, L], [L + 1], [0, L + 1, 0, 3 * L, 1, L + 1]])
def test_long_row_plan_edge_cases(lengths):
    row_ptr = torch.tensor(np.concatenate([[0], np.cumsum(lengths)]), dtype=torch.int32)
    nnz = int(sum(lengths))
    plan = segment.long_row_plan(row_ptr, nnz).numpy()
    want = [r for r, n in enumerate(lengths) if n > L]
    assert plan.shape == (nnz // (L + 1) + 1,)
    np.testing.assert_array_equal(plan[: len(want)], want)
    assert (plan[len(want):] == -1).all() and len(plan) > len(want)


def test_long_row_plan_is_built_from_tensor_operations(monkeypatch):
    """No Python loop over rows: ``long_row_plan`` never asks a tensor for
    a Python number."""
    g, _, _ = _ragged_graph()
    for name in ("item", "tolist", "__iter__", "__bool__", "__int__"):
        monkeypatch.setattr(torch.Tensor, name, lambda *a, **k: pytest.fail("read a tensor back on the host"))
    plan = segment.long_row_plan(g.row_ptr, g.nnz)
    monkeypatch.undo()
    assert plan.equal(g.long_rows)


def test_spmm_and_its_gradient_carry_the_plan():
    """The differentiable products hand the plan on and give the plain
    result on the CPU, with a symmetric graph and with a transposed one."""
    g, _, _ = _ragged_graph()
    x = torch.randn(g.n_cols, 8, requires_grad=True)
    out = tgraph.spmm(g, x)
    ref = segment.segment_spmm_plain(g.row_ptr, g.cols, g.vals, x.detach(), g.n_rows)
    assert torch.equal(out.detach(), ref)
    g_bar = torch.randn(g.n_rows, 8)
    (x_bar,) = torch.autograd.grad(out, x, g_bar)
    t = g.transposed()
    assert torch.allclose(x_bar, segment.segment_spmm_plain(t.row_ptr, t.cols, t.vals, g_bar, t.n_rows), atol=1e-5)
    assert len(tgraph._as_operands(g)) == 7 and tgraph._as_operands(g)[-1] is g.long_rows


# ---------------------------------------------------------------- K3

def _pack(dense):
    return torch.from_numpy(np.packbits(dense, axis=1, bitorder="little"))


def _check_selection(scores, k, dense_mask=None, head=0):
    packed = None if dense_mask is None else _pack(dense_mask)
    v, i, counts = grouped_topk_selection_plain(scores, k, packed, head=head, with_counts=True)
    v_ref, i_ref = grouped_topk_plain(scores, k, packed)
    assert torch.equal(i, i_ref)
    fin = torch.isfinite(v_ref.float())
    assert torch.equal(v[fin], v_ref[fin])
    assert torch.equal(torch.isfinite(v.float()), fin)
    return counts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,k,masked", [
    (8, 7050, 50, True), (8, 7050, 1, False), (4, 6400, 50, False), (3, 63001, 50, True),
    (5, 2000, 64, True), (5, 333, 2, False), (6, 100, 50, True), (6, 7049, 50, False),
])
def test_selection_matches_plain_and_jax(dtype, b, n, k, masked):
    rng = np.random.default_rng(n + k)
    s = rng.standard_normal((b, n)).astype(np.float32)
    dense = np.zeros((b, n), bool)
    if masked:
        dense[np.arange(b)[:, None], rng.integers(0, n, (b, 30))] = True
    scores = torch.from_numpy(s).to(dtype)
    for head in (0, 1, 3):
        counts = _check_selection(scores, k, dense if masked else None, head=head)
    if n >= 2000 and dtype == torch.float32:
        assert int(counts.max()) < 3 * k + 8  # about -256 ln(1 - k/256) columns pass
    # jax.lax.top_k on the same masked row
    masked_s = np.where(dense, -np.inf, scores.float().numpy())
    _, j_idx = jax.lax.top_k(masked_s, k)
    _, idx = grouped_topk_selection_plain(scores, k, _pack(dense) if masked else None)
    # bfloat16 rows hold real ties, which lax.top_k breaks the same way
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 2, 50, 64])
def test_selection_on_adversarial_rows(dtype, k):
    n = 1500
    rng = np.random.default_rng(k)
    base = torch.from_numpy(rng.standard_normal((9, n)).astype(np.float32))
    s = base.clone()
    s[0] = 0.25  # constant
    s[1] = float("-inf")  # nothing finite
    s[2, 7:] = float("-inf")  # seven finite scores
    s[3] = torch.round(s[3])  # a handful of distinct values: ties at the threshold
    s[4, ::2] = s[4].max()  # half the row tied at the top
    s[5] = -s[5].abs()
    s[5, 100:900] = 0.0  # 800 zeros above the rest, of both signs
    s[5, 100:900:2] = -0.0
    s[6, : n - 3] = float("-inf")  # the finite scores at the row's end
    s[7] = torch.arange(n) % 3  # three values in a period
    dense = np.zeros((9, n), bool)
    dense[8, : n - max(k - 5, 1)] = True  # all but j < k columns masked
    for head in (0, 2):
        counts = _check_selection(s.to(dtype), k, dense, head=head)
    if k > 1:
        assert int(counts[0]) > _K3_CAP and int(counts[1]) > _K3_CAP and int(counts[8]) > _K3_CAP


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_selection_tie_rule_and_masked_tail(dtype):
    """The contract's corner cases, as grouped_topk's own test states them."""
    s = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0, 0.5, 2.0, 1.0]]).to(dtype)
    v, i = grouped_topk_selection_plain(s, 5)
    assert i.tolist() == [[1, 2, 4, 3, 6]] and v.float().tolist() == [[3.0, 3.0, 3.0, 2.0, 2.0]]
    dense = np.array([[True, False, True, True, False, True, True, True]])
    v, i = grouped_topk_selection_plain(s, 4, _pack(dense))
    assert i.tolist() == [[1, 4, 0, 2]]  # out of finite values: masked columns in index order
    assert v.float().tolist()[0][:2] == [3.0, 3.0] and torch.isinf(v.float()[0, 2:]).all()


@st.composite
def _rows(draw):
    n = draw(st.sampled_from([5, 64, 100, 127, 128, 129, 1000, 1027, 2055]))
    k = draw(st.sampled_from([1, 2, 50, 64]).filter(lambda k: k <= n))
    kind = draw(st.sampled_from(["constant", "few_values", "mostly_neg_inf", "mostly_masked", "gaussian", "ties_at_top"]))
    seed = draw(st.integers(0, 2**16))
    bf16 = draw(st.booleans())
    head = draw(st.integers(0, 7))
    return n, k, kind, seed, bf16, head


@settings(max_examples=60, deadline=None)
@given(_rows())
def test_selection_hypothesis(case):
    n, k, kind, seed, bf16, head = case
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((3, n)).astype(np.float32)
    dense = np.zeros((3, n), bool)
    if kind == "constant":
        s[:] = s[0, 0]
    elif kind == "few_values":
        s = np.round(s * 2) / 2
    elif kind == "mostly_neg_inf":
        keep = rng.integers(0, k + 2)
        s[:, rng.permutation(n)[keep:]] = -np.inf
    elif kind == "mostly_masked":
        keep = rng.integers(0, k + 2)
        dense[:, rng.permutation(n)[keep:]] = True
    elif kind == "ties_at_top":
        s[:, rng.permutation(n)[: n // 2]] = 5.0
    scores = torch.from_numpy(s)
    _check_selection(scores.bfloat16() if bf16 else scores, k, dense, head=head)


# ---------------------------------------------------------------- the key

def test_order_key_is_monotone_on_float32():
    rng = np.random.default_rng(1)
    tiny = np.float32(1e-45)  # the smallest denormal
    special = np.array(
        [-np.inf, np.inf, 0.0, -0.0, tiny, -tiny, np.float32(1e-39), -np.float32(1e-39),
         np.finfo(np.float32).tiny, -np.finfo(np.float32).tiny, np.finfo(np.float32).max, np.finfo(np.float32).min,
         1.0, -1.0], np.float32)
    x = np.sort(np.concatenate([special, rng.standard_normal(5000).astype(np.float32),
                                (rng.standard_normal(2000) * 1e-40).astype(np.float32)]))
    key = order_key(torch.from_numpy(x)).numpy()
    assert key.min() >= 1 and key.max() < 2**32
    assert (np.diff(key) >= 0).all()
    # a larger float has a larger key; equal floats (-0 and +0 too) share one
    assert ((np.diff(key) > 0) == (np.diff(x) > 0)).all()
    nan_keys = order_key(torch.tensor([float("nan"), -float("nan")])).tolist()
    assert nan_keys == [0xFFFFFFFF, 0xFFFFFFFF] and key.max() < 0xFFFFFFFF


def test_order_key_is_monotone_on_every_bfloat16():
    bits = torch.arange(-(2**15), 2**15, dtype=torch.int32).to(torch.int16)
    x = bits.view(torch.bfloat16)
    real = ~torch.isnan(x.float())
    xs, order = torch.sort(x[real].float(), stable=True)
    key = order_key(x[real])[order].numpy()
    assert key.min() >= 1 and (key & 0xFFFF == 0).all()
    steps, gaps = np.diff(key), np.diff(xs.numpy())
    assert ((steps > 0) == (gaps > 0)).all() and (steps >= 0).all()
    assert (order_key(x[~real]) == 0xFFFF0000).all() and key.max() < 0xFFFF0000
    # the key of a bfloat16 is the key of the float32 it widens to, cut
    assert torch.equal(order_key(x[real]), order_key(x[real].float()) & 0xFFFF0000)
