"""The port's message-passing layer (``genmmrec_tpu_torch/ops/mp.py``) against
``genmmrec_tpu.ops.mp``, on the CPU, on the same seeded numpy edges.

``degree``, ``sort_edges_by_dst``, ``propagate`` (``add``, ``mean``,
``max``, with and without edge weights), ``add_self_loops``,
``segment_softmax`` and ``dropout_edge_mask`` (the JAX uniforms injected)
are held to rtol 1e-6 / atol 1e-7; ``add`` also bit for bit against the
Pallas ``sorted_segment_sum`` in interpret mode on integer-valued operands
(exact in its bf16 split); the x- and edge-weight gradients of
``propagate`` against ``jax.grad`` at rtol 1e-5 (float32 summation order),
on graphs built with and without the ``symmetric`` declaration (the
backward on the same edges or on the transposed CSR).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genmmrec_tpu.ops import mp as jmp
from genmmrec_tpu.ops.segment_pallas import CHUNK, chunk_span, sorted_segment_sum
from genmmrec_tpu_torch.ops import mp as tmp

CPU = torch.device("cpu")
N_NODES, N_EDGES = 500, 3000


def _edges(seed=0, n=N_NODES, e=N_EDGES, isolated=7):
    """Random directed edges; the last ``isolated`` nodes receive none."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, e), rng.integers(0, n - isolated, e)


def _mirrored(seed=0, n_users=200, n_items=300, e=1500):
    """A user-item edge set in both directions (unique pairs), as the models build it."""
    rng = np.random.default_rng(seed)
    pairs = np.unique(np.stack([rng.integers(0, n_users, e), rng.integers(0, n_items, e)], 1), axis=0)
    u, i = pairs[:, 0], pairs[:, 1] + n_users
    return np.concatenate([u, i]), np.concatenate([i, u]), n_users + n_items


def _t(a):
    return torch.from_numpy(np.array(a))


def test_degree_matches():
    src, dst = _edges(1)
    w = np.random.default_rng(2).standard_normal(len(dst)).astype(np.float32)
    np.testing.assert_array_equal(tmp.degree(_t(dst), N_NODES).numpy(), np.asarray(jmp.degree(jnp.asarray(dst), N_NODES)))
    np.testing.assert_allclose(
        tmp.degree(_t(dst), N_NODES, _t(w)).numpy(), np.asarray(jmp.degree(jnp.asarray(dst), N_NODES, jnp.asarray(w))),
        rtol=1e-6, atol=1e-7,
    )


def test_sort_edges_by_dst_and_message_graph():
    src, dst = _edges(3)
    ref_src, ref_dst, _ = jmp.sort_edges_by_dst(src, dst, N_NODES)
    got_src, got_dst = tmp.sort_edges_by_dst(src, dst)
    np.testing.assert_array_equal(got_src, ref_src)
    np.testing.assert_array_equal(got_dst, ref_dst)
    g = tmp.message_graph(got_src, got_dst, N_NODES, CPU)
    np.testing.assert_array_equal(g.rows.numpy(), ref_dst)
    np.testing.assert_array_equal(g.cols.numpy(), ref_src)
    assert (g.vals == 1).all() and not g.symmetric
    np.testing.assert_array_equal(np.diff(g.row_ptr.numpy()), np.bincount(dst, minlength=N_NODES))
    with pytest.raises(ValueError, match="sorted by destination"):
        tmp.message_graph(src, dst, N_NODES, CPU)


def _case(seed, weighted, d=24):
    src, dst = tmp.sort_edges_by_dst(*_edges(seed))
    rng = np.random.default_rng(seed + 100)
    x = rng.standard_normal((N_NODES, d)).astype(np.float32)
    w = rng.uniform(0.1, 2.0, len(dst)).astype(np.float32) if weighted else None
    return src, dst, x, w


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("aggr", ["add", "mean", "max"])
def test_propagate_matches(aggr, weighted):
    src, dst, x, w = _case(5, weighted)
    g = tmp.message_graph(src, dst, N_NODES, CPU)
    got = tmp.propagate(_t(x), g, aggr, None if w is None else _t(w)).numpy()
    ref = np.asarray(jmp.propagate(
        jnp.asarray(x), jnp.asarray(src), jnp.asarray(dst), N_NODES, aggr, None if w is None else jnp.asarray(w)
    ))
    assert got.shape == (N_NODES, x.shape[1])
    if aggr == "max":
        assert np.isneginf(ref[-7:]).all()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_propagate_add_matches_pallas_interpret(weighted):
    """``add`` against the Pallas kernel in interpret mode on integer-valued
    operands: every partial sum is exact, so both must agree bit for bit."""
    src, dst, _, _ = _case(7, weighted)
    rng = np.random.default_rng(8)
    x = rng.integers(-4, 5, (N_NODES, 32)).astype(np.float32)
    w = rng.integers(1, 4, len(dst)).astype(np.float32) if weighted else np.ones(len(dst), np.float32)
    span = chunk_span(dst, N_NODES)
    assert span > 0
    gathered = jnp.asarray(x)[src] * jnp.asarray(w)[:, None]
    ref = np.asarray(sorted_segment_sum(gathered, jnp.asarray(dst), N_NODES, span, CHUNK, True))
    g = tmp.message_graph(src, dst, N_NODES, CPU)
    got = tmp.propagate(_t(x), g, "add", _t(w) if weighted else None).numpy()
    np.testing.assert_array_equal(got, ref)


def _grads(src, dst, n, x, w, g_bar, aggr, symmetric):
    ref_fn = lambda x_, w_: (jmp.propagate(x_, jnp.asarray(src), jnp.asarray(dst), n, aggr, w_) * g_bar).sum()
    if w is None:
        ref = (np.asarray(jax.grad(lambda x_: ref_fn(x_, None))(jnp.asarray(x))), None)
    else:
        ref = tuple(np.asarray(a) for a in jax.grad(ref_fn, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w)))
    g = tmp.message_graph(src, dst, n, CPU, symmetric=symmetric)
    xt = _t(x).requires_grad_()
    wt = None if w is None else _t(w).requires_grad_()
    (tmp.propagate(xt, g, aggr, wt) * _t(g_bar)).sum().backward()
    return (xt.grad.numpy(), None if wt is None else wt.grad.numpy()), ref


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("aggr", ["add", "mean", "max"])
def test_propagate_gradients_match(aggr, weighted):
    """x- and edge-weight gradients against ``jax.grad``: on directed edges
    (the backward over the transposed CSR) and on a mirrored edge set
    declared ``symmetric`` (unit values: the backward on the same edges; an
    edge weight turns the declaration off)."""
    for src, dst, n, symmetric in (
        (*_edges(11), N_NODES, False),
        (*_mirrored(12), True),
    ):
        src, dst = tmp.sort_edges_by_dst(src, dst)
        rng = np.random.default_rng(13)
        x = rng.standard_normal((n, 16)).astype(np.float32)
        w = rng.uniform(0.1, 2.0, len(dst)).astype(np.float32) if weighted else None
        g_bar = rng.standard_normal((n, 16)).astype(np.float32)
        got, ref = _grads(src, dst, n, x, w, g_bar, aggr, symmetric)
        np.testing.assert_allclose(got[0], ref[0], rtol=1e-5, atol=1e-6, err_msg=f"x, symmetric={symmetric}")
        if weighted:
            np.testing.assert_allclose(got[1], ref[1], rtol=1e-5, atol=1e-6, err_msg=f"w, symmetric={symmetric}")


def test_add_self_loops_matches():
    src, dst = _edges(17)
    got = tmp.add_self_loops(_t(src), _t(dst), N_NODES)
    ref = jmp.add_self_loops(jnp.asarray(src), jnp.asarray(dst), N_NODES)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[0].dtype == torch.int64 and got[0].shape == (N_EDGES + N_NODES,)


def test_segment_softmax_matches():
    src, dst = _edges(19)
    scores = np.random.default_rng(20).standard_normal(len(dst)).astype(np.float32) * 4
    got = tmp.segment_softmax(_t(scores), _t(dst), N_NODES).numpy()
    ref = np.asarray(jmp.segment_softmax(jnp.asarray(scores), jnp.asarray(dst), N_NODES))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    sums = np.bincount(dst, weights=got, minlength=N_NODES)
    np.testing.assert_allclose(sums[np.bincount(dst, minlength=N_NODES) > 0], 1.0, rtol=1e-5)


@pytest.mark.parametrize("keep_prob", [0.1, 0.5, 0.9])
def test_dropout_edge_mask_matches(keep_prob):
    key = jax.random.PRNGKey(int(keep_prob * 10))
    ref = np.asarray(jmp.dropout_edge_mask(key, N_EDGES, keep_prob))
    uniform = _t(np.asarray(jax.random.uniform(key, (N_EDGES,))))
    got = tmp.dropout_edge_mask(N_EDGES, keep_prob, uniform=uniform)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    drawn = tmp.dropout_edge_mask(N_EDGES, keep_prob, torch.Generator().manual_seed(0))
    assert set(drawn.unique().tolist()) <= {0.0, 1.0} and abs(drawn.mean().item() - keep_prob) < 0.03
    with pytest.raises(ValueError):
        tmp.dropout_edge_mask(N_EDGES, keep_prob)
