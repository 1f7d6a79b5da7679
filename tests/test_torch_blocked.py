"""K2's plain version and the blocked dispatch of the port against the JAX
package's blocked segment sum, on the CPU.

``segment_spmm_blocked_plain`` and ``spmm`` on a graph flagged ``blocked``
are held against ``sorted_segment_sum_blocked`` and
``spmm_symmetric_blocked`` in Pallas interpret mode with the VMEM budget
shrunk so that the plan splits the graph (2e-3: the kernel's bf16 hi/lo
split), and against XLA's ``segment_sum`` (1e-5: float32 summation order).
The graphs have a row that spans several of the reference's blocks and of
the port's 128-edge chunks, and rows without edges.

Also here, as they share the graph constructors: the gradient of ``spmm`` on a
graph that is not symmetric (``ui_norm_adj``) against ``jax.grad``,
``spmm_t``, ``edge_dropout`` with JAX's draw injected, and ``SparseGraph.to``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genmmrec_tpu.ops.segment_pallas as sp
from genmmrec_tpu.ops import graph as jgraph
from genmmrec_tpu_torch.ops import graph as tgraph
from genmmrec_tpu_torch.ops import segment

CPU = torch.device("cpu")
_t = torch.from_numpy


@pytest.fixture
def small_budgets(monkeypatch):
    """Both packages' size rules shrunk so that a modest graph is split."""
    monkeypatch.setattr(sp, "_VMEM_BUDGET", 4 * 1024 * 1024)
    monkeypatch.setattr(segment, "L2_BYTES", 1024 * 1024)


def _skewed_symmetric_graph(seed=11, n=20000, n_edges=120000, hub_edges=9000, gap=40):
    """Row-sorted value-symmetric edges with self loops over ``n - gap``
    active nodes, a band of ``gap`` nodes in the middle without any edge (the
    reference's blocked sum drops empty rows at the end of the graph, so
    there are none there), and one hub row of ``hub_edges`` edges, longer than
    four 2,048-edge scan steps and than many 128-edge chunks."""
    rng = np.random.default_rng(seed)
    active = n - gap
    node = lambda ids: np.where(ids < active // 2, ids, ids + gap)
    a, b = node(rng.integers(0, active, n_edges)), node(rng.integers(0, active, n_edges))
    hub = np.full(hub_edges, 77)
    spokes = node(rng.choice(active, size=hub_edges, replace=False))
    loops = node(np.arange(active))
    rows = np.concatenate([a, b, hub, spokes, loops])
    cols = np.concatenate([b, a, spokes, hub, loops])
    v = rng.random(n_edges + hub_edges).astype(np.float32)
    vals = np.concatenate([v[:n_edges], v[:n_edges], v[n_edges:], v[n_edges:], np.ones(len(loops), np.float32)])
    order = np.argsort(rows, kind="stable")
    return rows[order].astype(np.int32), cols[order].astype(np.int32), vals[order], n


def test_kernel_choice_follows_the_graph_size(small_budgets):
    assert segment.takes_blocked(4097) and not segment.takes_blocked(4096)
    rows, cols, vals, n = _skewed_symmetric_graph()
    g = tgraph.sorted_graph(_t(rows), _t(cols), _t(vals), n, n, symmetric=True)
    assert g.blocked and dataclasses.replace(g, vals=g.vals * 2).blocked
    small = tgraph.sorted_graph(_t(rows[:100]), _t(cols[:100]), _t(vals[:100]), 3000, n)
    assert not small.blocked


def test_elec_takes_k2_and_baby_k1():
    """With the module's own constant: the 255,404-row Amazon-elec adjacency
    is over the size rule, Amazon-baby's 26,495 rows are under it."""
    assert segment.takes_blocked(192403 + 63001) and not segment.takes_blocked(19445 + 7050)


@pytest.mark.parametrize("d", [64, 128])
def test_blocked_plain_matches_sorted_segment_sum_blocked(small_budgets, d):
    rows, cols, vals, n = _skewed_symmetric_graph()
    assert np.bincount(rows, minlength=n).max() > 4 * 2048 and (np.bincount(rows, minlength=n) == 0).any()
    plan = sp.block_plan(rows, n)
    assert plan is not None and plan[1] >= 2
    x = np.random.default_rng(d).standard_normal((n, d)).astype(np.float32)
    gathered = jnp.asarray(vals)[:, None] * jnp.asarray(x)[jnp.asarray(cols)]
    pal = np.asarray(sp.sorted_segment_sum_blocked(gathered, jnp.asarray(rows), n, plan, sp.CHUNK, True))
    xla = np.asarray(jax.ops.segment_sum(gathered, jnp.asarray(rows), num_segments=n, indices_are_sorted=True))
    out = segment.segment_spmm_blocked_plain(_t(rows), _t(cols), _t(vals), _t(x), n).numpy()
    np.testing.assert_allclose(out, xla, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out, pal, rtol=2e-3, atol=2e-3)
    assert not out[np.bincount(rows, minlength=n) == 0].any()
    # the wrapper on CPU tensors is the plain version, and counts no launch
    g = tgraph.sorted_graph(_t(rows), _t(cols), _t(vals), n, n)
    before = segment.segment_spmm_blocked.launches
    via = segment.segment_spmm_blocked(g.row_ptr, g.rows, g.cols, g.vals, _t(x), n).numpy()
    np.testing.assert_array_equal(via, out)
    assert segment.segment_spmm_blocked.launches == before


def test_blocked_symmetric_spmm_values_and_grads_match_jax(small_budgets):
    rows, cols, vals, n = _skewed_symmetric_graph()
    plan = sp.block_plan(rows, n)
    assert plan is not None and plan[1] >= 2
    rng = np.random.default_rng(6)
    x = rng.standard_normal((n, 64)).astype(np.float32)
    w = rng.standard_normal((n, 64)).astype(np.float32)
    rj, cj = jnp.asarray(rows), jnp.asarray(cols)
    pal = lambda v, xx: sp.spmm_symmetric_blocked(rj, cj, v, xx, n, plan, sp.CHUNK, True)
    xla = lambda v, xx: jax.ops.segment_sum(v[:, None] * xx[cj], rj, num_segments=n, indices_are_sorted=True)
    grads = lambda f: jax.grad(lambda v, xx: (f(v, xx) * w).sum(), argnums=(0, 1))(jnp.asarray(vals), jnp.asarray(x))
    (pv, px), (rv, rx) = grads(pal), grads(xla)

    tv, tx = _t(vals).requires_grad_(), _t(x).requires_grad_()
    g = tgraph.sorted_graph(_t(rows), _t(cols), tv, n, n, symmetric=True)
    assert g.blocked and g.vals is tv
    counts = (segment.segment_spmm_blocked.launches, segment.segment_spmm_blocked_backward.launches)
    out = tgraph.spmm(g, tx)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(xla(jnp.asarray(vals), jnp.asarray(x))), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(pal(jnp.asarray(vals), jnp.asarray(x))), rtol=2e-3, atol=2e-3)
    (out * _t(w)).sum().backward()
    assert (segment.segment_spmm_blocked.launches, segment.segment_spmm_blocked_backward.launches) == counts
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(rx), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(rv), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(px), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(pv), rtol=2e-3, atol=2e-3)


def _ui_edges(seed=0, n_users=300, n_items=1600, n=5000):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n_users, n), rng.integers(0, n_items, n), n_users, n_items


@pytest.mark.parametrize("blocked", [False, True], ids=["k1", "k2"])
def test_ui_norm_adj_and_its_spmm_gradient_match_jax(monkeypatch, blocked):
    """A rectangular graph that is not symmetric: its edges and values, ``spmm`` and both gradients against ``jax.grad`` of the JAX
    ``spmm`` (1e-5: summation order). The x-gradient runs over the port's
    transposed CSR, built at the first backward and kept."""
    if blocked:
        monkeypatch.setattr(segment, "L2_BYTES", 16 * 1024)
    users, items, nu, ni = _ui_edges()
    jg = jgraph.ui_norm_adj(users, items, nu, ni)
    tg = tgraph.ui_norm_adj(users, items, nu, ni, CPU)
    assert (tg.n_rows, tg.n_cols, tg.symmetric, tg.blocked) == (nu, ni, False, blocked)
    np.testing.assert_array_equal(tg.rows.numpy(), np.asarray(jg.rows))
    np.testing.assert_array_equal(tg.cols.numpy(), np.asarray(jg.cols))
    np.testing.assert_array_equal(tg.vals.numpy(), np.asarray(jg.vals))
    uu, ii = tgraph.unique_ui_pairs(users, items)
    ju, ji = jgraph.unique_ui_pairs(users, items)
    np.testing.assert_array_equal(uu, ju)
    np.testing.assert_array_equal(ii, ji)

    rng = np.random.default_rng(2)
    x = rng.standard_normal((ni, 64)).astype(np.float32)
    w = rng.standard_normal((nu, 64)).astype(np.float32)
    f = lambda v, xx: (jgraph.spmm(dataclasses.replace(jg, vals=v), xx) * w).sum()
    ref, (rv, rx) = jax.value_and_grad(f, argnums=(0, 1))(jg.vals, jnp.asarray(x))

    tv, tx = tg.vals.clone().requires_grad_(), _t(x).requires_grad_()
    g = dataclasses.replace(tg, vals=tv)
    assert not tg._transpose
    total = (tgraph.spmm(g, tx) * _t(w)).sum()
    total.backward()
    np.testing.assert_allclose(total.item(), float(ref), rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(rx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(rv), rtol=1e-5, atol=1e-5)
    # the transpose's structure now sits with the graph, and with its copies
    assert set(tg._transpose) == {"perm", "rows", "cols", "row_ptr", "long_rows"} and g._transpose is tg._transpose
    t = tg.transposed()
    assert (t.n_rows, t.n_cols) == (ni, nu) and bool((t.rows[1:] >= t.rows[:-1]).all())
    dense = torch.zeros(nu, ni).index_put_((tg.rows.long(), tg.cols.long()), tg.vals)
    dense_t = torch.zeros(ni, nu).index_put_((t.rows.long(), t.cols.long()), t.vals)
    np.testing.assert_array_equal(dense_t.numpy(), dense.T.numpy())
    np.testing.assert_array_equal(np.diff(t.row_ptr.numpy()), np.bincount(t.rows.numpy(), minlength=ni))


def test_spmm_t_matches_jax():
    users, items, nu, ni = _ui_edges(seed=3)
    jg, tg = jgraph.ui_norm_adj(users, items, nu, ni), tgraph.ui_norm_adj(users, items, nu, ni, CPU)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((nu, 32)).astype(np.float32)
    w = rng.standard_normal((ni, 32)).astype(np.float32)
    ref, rx = jax.value_and_grad(lambda xx: (jgraph.spmm_t(jg, xx) * w).sum())(jnp.asarray(x))
    tx = _t(x).requires_grad_()
    out = tgraph.spmm_t(tg, tx)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jgraph.spmm_t(jg, jnp.asarray(x))), rtol=1e-5, atol=1e-6)
    (out * _t(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(rx), rtol=1e-5, atol=1e-5)
    # an unsorted graph takes the scatter on the CPU
    unsorted = dataclasses.replace(tg, sorted=False)
    np.testing.assert_allclose(tgraph.spmm_t(unsorted, _t(x)).numpy(), out.detach().numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("paired", [False, True], ids=["unpaired", "paired"])
def test_edge_dropout_with_the_jax_draw(paired):
    users, items, nu, ni = _ui_edges(seed=5)
    jg = jgraph.bipartite_norm_adj(users, items, nu, ni)
    tg = tgraph.bipartite_norm_adj(users, items, nu, ni, CPU)
    key, keep_prob = jax.random.PRNGKey(3), 0.7
    ref = jgraph.edge_dropout(key, jg, keep_prob, paired=paired)
    n = jg.nnz // 2 if paired else jg.nnz
    keep = np.asarray(jax.random.bernoulli(key, keep_prob, (n,)))
    out = tgraph.edge_dropout(tg, keep_prob, paired=paired, keep=_t(keep.copy()))
    np.testing.assert_allclose(out.vals.numpy(), np.asarray(ref.vals), rtol=1e-6, atol=0)
    assert out.symmetric and ref.symmetric and out.rows is tg.rows and (out.vals == 0).any()
    # its own draw: about keep_prob of the edges stay, scaled by 1/keep_prob
    drawn = tgraph.edge_dropout(tg, keep_prob, paired=paired, generator=torch.Generator().manual_seed(0))
    kept = drawn.vals != 0
    assert abs(kept.float().mean().item() - keep_prob) < 0.03
    np.testing.assert_allclose(drawn.vals[kept].numpy(), (tg.vals[kept] / keep_prob).numpy(), rtol=1e-6)
    if paired:
        half = tg.nnz // 2
        assert torch.equal(kept[:half], kept[half:])
    with pytest.raises(ValueError, match="generator"):
        tgraph.edge_dropout(tg, keep_prob)


def test_to_carries_the_static_fields_and_the_transpose(small_budgets):
    rows, cols, vals, n = _skewed_symmetric_graph(n=6000, n_edges=20000, hub_edges=500)
    g = tgraph.sorted_graph(_t(rows), _t(cols), _t(vals), n, n)
    g.transposed()
    moved = g.to(torch.device("meta"))
    assert moved.blocked and not moved.symmetric and moved.rows.device.type == "meta"
    assert set(moved._transpose) == set(g._transpose)
    assert all(v.device.type == "meta" for v in moved._transpose.values())
    assert all(v.device.type == "cpu" for v in g._transpose.values())
