"""The port's graph ops and the plain versions of its two kernels against the
JAX package, on the CPU.

K1 (``segment_spmm``) is held against the JAX ``spmm`` (``segment_sum``) and
against the Pallas ``sorted_segment_sum`` in interpret mode, whose bf16
hi/lo split bounds its own error near 2e-3. K3 (``grouped_topk``) is held
against the JAX ``grouped_topk`` on both of its paths and against the
Pallas candidate gather in interpret mode; indices must be equal (the
inputs are continuous draws, so there are no ties).

K1's backward (``spmm_symmetric``) is held against the gradients of the JAX
``spmm_symmetric`` in interpret mode (2e-3, its bf16 split) and of XLA's
``segment_sum`` (1e-5, float32 summation order).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genmmrec_tpu.ops import graph as jgraph
from genmmrec_tpu.ops.segment_pallas import CHUNK, chunk_span, dense_rows_span, sorted_segment_sum
from genmmrec_tpu.ops.segment_pallas import spmm_symmetric as j_spmm_symmetric
from genmmrec_tpu.ops.topk import _candidate_gather_pallas, _unpack_bits
from genmmrec_tpu.ops.topk import grouped_topk as j_topk
from genmmrec_tpu_torch.ops import _build
from genmmrec_tpu_torch.ops import graph as tgraph
from genmmrec_tpu_torch.ops.segment import segment_spmm, segment_spmm_backward, segment_spmm_plain
from genmmrec_tpu_torch.ops.topk import grouped_topk, unpack_mask

CPU = torch.device("cpu")


def _edges(seed=0, n_users=300, n_items=1600, n=5000):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n_users, n), rng.integers(0, n_items, n), n_users, n_items


def _graphs():
    users, items, nu, ni = _edges()
    return jgraph.bipartite_norm_adj(users, items, nu, ni), tgraph.bipartite_norm_adj(users, items, nu, ni, CPU)


def test_bipartite_norm_adj_matches():
    jg, tg = _graphs()
    assert tg.nnz >= 2048 and (tg.n_rows, tg.n_cols, tg.symmetric) == (jg.n_rows, jg.n_cols, True)
    np.testing.assert_array_equal(tg.rows.numpy(), np.asarray(jg.rows))
    np.testing.assert_array_equal(tg.cols.numpy(), np.asarray(jg.cols))
    np.testing.assert_array_equal(tg.vals.numpy(), np.asarray(jg.vals))
    counts = np.bincount(np.asarray(jg.rows), minlength=jg.n_rows)
    np.testing.assert_array_equal(np.diff(tg.row_ptr.numpy()), counts)
    # the device-side builder gives the same row pointer
    tg2 = tgraph.sorted_graph(tg.rows, tg.cols, tg.vals, tg.n_rows, tg.n_cols, symmetric=True)
    np.testing.assert_array_equal(tg2.row_ptr.numpy(), tg.row_ptr.numpy())


@pytest.mark.parametrize("d", [64, 128, 192])
def test_spmm_matches_jax(d):
    jg, tg = _graphs()
    x = np.random.default_rng(d).standard_normal((jg.n_cols, d)).astype(np.float32)
    ref = np.asarray(jgraph.spmm(jg, jnp.asarray(x)))
    out = tgraph.spmm(tg, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
    # against the Pallas kernel itself, in interpret mode
    assert jg.pallas_span > 0
    gathered = jg.vals[:, None] * jnp.asarray(x)[jg.cols]
    pal = np.asarray(sorted_segment_sum(gathered, jg.rows, jg.n_rows, jg.pallas_span, CHUNK, True))
    np.testing.assert_allclose(out, pal, rtol=2e-3, atol=2e-3)


def test_spmm_on_a_regenerated_graph():
    """A rebuild_ui_graph-shaped graph: top-1 user-item edges, both
    directions, plus self loops on every node."""
    rng = np.random.default_rng(3)
    nu, ni, d = 600, 1600, 64
    N = nu + ni
    top = rng.integers(0, ni, nu)
    rows = np.concatenate([np.arange(nu), top + nu, np.arange(N)])
    cols = np.concatenate([top + nu, np.arange(nu), np.arange(N)])
    deg = np.bincount(rows, minlength=N).astype(np.float32)
    vals = (deg[rows] ** -0.5 * deg[cols] ** -0.5).astype(np.float32)
    order = np.argsort(rows, kind="stable")
    rows, cols, vals = rows[order], cols[order], vals[order]
    assert len(rows) >= 2048
    x = rng.standard_normal((N, d)).astype(np.float32)
    jg = jgraph.SparseGraph(
        rows=jnp.asarray(rows, jnp.int32), cols=jnp.asarray(cols, jnp.int32),
        vals=jnp.asarray(vals), n_rows=N, n_cols=N, symmetric=True,
    )
    tg = tgraph.sorted_graph(torch.from_numpy(rows), torch.from_numpy(cols), torch.from_numpy(vals), N, N, True)
    out = tgraph.spmm(tg, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(jgraph.spmm(jg, jnp.asarray(x))), rtol=1e-5, atol=1e-6)
    gathered = jg.vals[:, None] * jnp.asarray(x)[jg.cols]
    pal = np.asarray(sorted_segment_sum(gathered, jg.rows, N, dense_rows_span(N), CHUNK, True))
    np.testing.assert_allclose(out, pal, rtol=2e-3, atol=2e-3)


def test_spmm_multi_splits_columns_and_empty_rows_are_zero():
    jg, tg = _graphs()
    rng = np.random.default_rng(5)
    a = rng.standard_normal((tg.n_cols, 64)).astype(np.float32)
    b = rng.standard_normal((tg.n_cols, 64)).astype(np.float32)
    ja, jb = jgraph.spmm_multi(jg, [jnp.asarray(a), jnp.asarray(b)])
    ta, tb = tgraph.spmm_multi(tg, [torch.from_numpy(a), torch.from_numpy(b)])
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-5, atol=1e-6)
    empty = (tg.row_ptr[1:] == tg.row_ptr[:-1]).numpy()
    assert empty.any()  # items with no train edge
    assert not ta.numpy()[empty].any()


def test_cpu_tensors_take_the_plain_versions():
    jg, tg = _graphs()
    n1, n3 = segment_spmm.launches, grouped_topk.launches
    tgraph.spmm(tg, torch.ones(tg.n_cols, 8))
    grouped_topk(torch.randn(4, 300), 5)
    assert (segment_spmm.launches, grouped_topk.launches) == (n1, n3)


def _scores(b, n, seed):
    return np.random.default_rng(seed).standard_normal((b, n)).astype(np.float32)


def _mask(b, n, per_row, seed):
    rng = np.random.default_rng(seed)
    dense = np.zeros((b, n), bool)
    for r in range(b):
        dense[r, rng.choice(n, size=per_row, replace=False)] = True
    return dense, np.packbits(dense, axis=1, bitorder="little")


@pytest.mark.parametrize(
    "b,n,k,masked",
    [
        (64, 13000, 50, False),  # two-stage path
        (64, 13000, 50, True),  # two-stage path, packed mask
        (256, 1600, 1, False),  # regeneration shape of the slice test
        (32, 1600, 50, True),  # narrow path, packed mask
        (16, 500, 7, False),  # narrow path
    ],
)
def test_grouped_topk_matches_jax(b, n, k, masked):
    s = _scores(b, n, seed=n + k)
    packed = _mask(b, n, 200 if n > 1000 else 50, seed=k)[1] if masked else None
    jv, ji = j_topk(jnp.asarray(s), k, packed_mask=None if packed is None else jnp.asarray(packed))
    tv, ti = grouped_topk(torch.from_numpy(s), k, None if packed is None else torch.from_numpy(packed))
    assert ti.dtype == torch.int64 and ti.shape == (b, k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_grouped_topk_matches_the_pallas_candidate_gather():
    """The TPU route of grouped_topk, its Pallas gather in interpret mode."""
    b, n, k, group = 32, 13000, 50, 128
    s = _scores(b, n, seed=11)
    dense, packed = _mask(b, n, 300, seed=12)
    n_groups = -(-n // group)
    neg_fin = np.finfo(np.float32).min
    s_pad = np.full((b, n_groups * group), -np.inf, np.float32)
    s_pad[:, :n] = s
    pm = np.zeros((b, n_groups * group // 8), np.uint8)
    pm[:, : packed.shape[1]] = packed
    sm3 = jnp.maximum(jnp.asarray(s_pad).reshape(b, n_groups, group), neg_fin)
    sm3 = jnp.where(_unpack_bits(jnp.asarray(pm).reshape(b, n_groups, group // 8), group), neg_fin, sm3)
    _, gidx = jax.lax.top_k(sm3.max(axis=-1), k)
    cand = _candidate_gather_pallas(sm3, gidx, k, group, interpret=True)
    _, pos = jax.lax.top_k(cand, k)
    cand_idx = (gidx[:, :, None] * group + jnp.arange(group)).reshape(b, k * group)
    ref = np.asarray(jnp.take_along_axis(cand_idx, pos, axis=1))
    _, ti = grouped_topk(torch.from_numpy(s), k, torch.from_numpy(packed))
    np.testing.assert_array_equal(ti.numpy(), ref)


def test_grouped_topk_tie_rule_and_masked_tail():
    """Equal values: lower index first. Rows with fewer than k unmasked
    entries end in -inf entries, lowest index first."""
    s = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0, 0.0, 5.0, 5.0, 1.0, 2.0]])
    dense = np.zeros((1, 10), bool)
    dense[0, [6, 7, 8, 9]] = True
    packed = torch.from_numpy(np.packbits(dense, axis=1, bitorder="little"))
    v, i = grouped_topk(s, 4)
    assert i.tolist() == [[6, 7, 1, 2]] and v.tolist() == [[5.0, 5.0, 3.0, 3.0]]
    s2 = s.clone()
    s2[0, :6] = 0.0
    v, i = grouped_topk(s2, 8, packed_mask=packed)
    assert i.tolist() == [[0, 1, 2, 3, 4, 5, 6, 7]]
    assert v[0, 6:].tolist() == [float("-inf")] * 2
    with pytest.raises(ValueError):
        grouped_topk(s, 11)


def test_unpack_mask_is_little_endian():
    dense, packed = _mask(5, 300, 40, seed=2)
    np.testing.assert_array_equal(unpack_mask(torch.from_numpy(packed), 300).numpy(), dense)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()


def test_library_name_follows_the_sources(monkeypatch, tmp_path):
    for name in os.listdir(_build.CSRC):
        (tmp_path / name).write_bytes(open(os.path.join(_build.CSRC, name), "rb").read())
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    before = _build.library_path()
    with open(tmp_path / "topk.cu", "a") as f:
        f.write("\n// changed\n")
    after = _build.library_path()
    assert before != after and os.path.dirname(after) == _build.BUILD_DIR


def _symmetric_graph(kind, seed=5):
    """Row-sorted value-symmetric edges (rows, cols, vals, n): a random
    graph with random values and self loops, or a regenerated modal graph
    (top-1 user-item edges both ways plus self loops, sym-normalized)."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        n = 1200
        a, b = rng.integers(0, n, 6000), rng.integers(0, n, 6000)
        rows = np.concatenate([a, b, np.arange(n)])
        cols = np.concatenate([b, a, np.arange(n)])
        v = rng.random(len(a)).astype(np.float32)
        vals = np.concatenate([v, v, np.ones(n, np.float32)])
    else:
        nu, ni = 600, 1600
        n = nu + ni
        top = rng.integers(0, ni, nu)
        rows = np.concatenate([np.arange(nu), top + nu, np.arange(n)])
        cols = np.concatenate([top + nu, np.arange(nu), np.arange(n)])
        deg = np.bincount(rows, minlength=n).astype(np.float32)
        vals = (deg[rows] ** -0.5 * deg[cols] ** -0.5).astype(np.float32)
    order = np.argsort(rows, kind="stable")
    return rows[order].astype(np.int32), cols[order].astype(np.int32), vals[order], n


@pytest.mark.parametrize("kind", ["random", "regenerated"])
@pytest.mark.parametrize("d", [64, 128, 192])
def test_spmm_grads_match_jax(kind, d):
    rows, cols, vals, n = _symmetric_graph(kind)
    span = chunk_span(rows, n) if kind == "random" else dense_rows_span(n)
    assert span > 0
    rng = np.random.default_rng(d)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal((n, d)).astype(np.float32)
    rj, cj = jnp.asarray(rows), jnp.asarray(cols)
    pal = lambda v, xx: j_spmm_symmetric(rj, cj, v, xx, n, span, CHUNK, True)
    xla = lambda v, xx: jax.ops.segment_sum(v[:, None] * xx[cj], rj, num_segments=n, indices_are_sorted=True)
    grads = lambda f: jax.grad(lambda v, xx: (f(v, xx) * w).sum(), argnums=(0, 1))(jnp.asarray(vals), jnp.asarray(x))
    (pv, px), (rv, rx) = grads(pal), grads(xla)

    tv = torch.from_numpy(vals).requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    tg = tgraph.sorted_graph(torch.from_numpy(rows), torch.from_numpy(cols), tv, n, n, symmetric=True)
    assert tg.vals is tv
    n1, n2 = segment_spmm.launches, segment_spmm_backward.launches
    (tgraph.spmm(tg, tx) * torch.from_numpy(w)).sum().backward()
    assert (segment_spmm.launches, segment_spmm_backward.launches) == (n1, n2)  # plain on the CPU
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(rx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(rv), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(px), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(pv), rtol=2e-3, atol=2e-3)


def test_spmm_backward_takes_any_cotangent_layout():
    """A stride-0 cotangent (the backward of a sum) and a slice's zero-padded
    one give the gradients of the plain version's own autograd."""
    rows, cols, vals, n = _symmetric_graph("regenerated")
    tg = tgraph.sorted_graph(torch.from_numpy(rows), torch.from_numpy(cols), torch.from_numpy(vals), n, n, True)
    x0 = torch.from_numpy(np.random.default_rng(1).standard_normal((n, 64)).astype(np.float32))
    for reduce in (lambda y: y.sum(), lambda y: y[:, 8:40].sum() + 2 * y[100:].sum()):
        x, x_ref = x0.clone().requires_grad_(), x0.clone().requires_grad_()
        reduce(tgraph.spmm(tg, x)).backward()
        reduce(segment_spmm_plain(tg.row_ptr, tg.cols, tg.vals, x_ref, n)).backward()
        np.testing.assert_allclose(x.grad.numpy(), x_ref.grad.numpy(), rtol=1e-6, atol=1e-6)
    stride0 = torch.ones(1, 1).expand(n, 64)
    assert not stride0.is_contiguous()
    out = segment_spmm_backward(tg.row_ptr, tg.cols, tg.vals, stride0, n)
    np.testing.assert_allclose(out.numpy(), segment_spmm_plain(tg.row_ptr, tg.cols, tg.vals, torch.ones(n, 64), n).numpy())


def test_non_symmetric_graph_with_grad_raises_off_the_cpu(monkeypatch):
    """Off the CPU a graph reaches the kernel or raises, with or without
    grad: meta tensors take the kernel's route without a card, where the
    missing library raises. Only the bare forward wrapper refuses operands
    that need grad, as it records no backward."""
    meta = torch.device("meta")
    n, nnz = 50, 200
    g = tgraph.SparseGraph(
        rows=torch.zeros(nnz, dtype=torch.int32, device=meta),
        cols=torch.zeros(nnz, dtype=torch.int32, device=meta),
        vals=torch.zeros(nnz, device=meta),
        row_ptr=torch.zeros(n + 1, dtype=torch.int32, device=meta),
        n_rows=n, n_cols=n, symmetric=False,
    )
    x = torch.zeros(n, 64, device=meta, requires_grad=True)
    with pytest.raises(RuntimeError, match="symmetric"):
        segment_spmm(g.row_ptr, g.cols, g.vals, x, n)

    def library():
        raise RuntimeError("kernel library reached")

    monkeypatch.setattr(_build, "library", library)
    # through spmm both kinds of graph go on to the kernel with these operands
    for graph in (g, dataclasses.replace(g, symmetric=True), dataclasses.replace(g, blocked=True)):
        with pytest.raises(RuntimeError, match="kernel library reached"):
            tgraph.spmm(graph, x)
    # on the CPU the plain version runs and differentiates
    rows, cols, vals, n = _symmetric_graph("random")
    cg = tgraph.sorted_graph(torch.from_numpy(rows), torch.from_numpy(cols), torch.from_numpy(vals), n, n)
    xc = torch.ones(n, 8, requires_grad=True)
    tgraph.spmm(cg, xc).sum().backward()
    assert xc.grad is not None and not cg.symmetric
