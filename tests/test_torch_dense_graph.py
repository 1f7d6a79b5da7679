"""The port's dense KNN helpers (``ops/graph.py`` ``build_sim``,
``norm_laplacian_dense``, ``dense_topk_plane``, ``knn_graph_dense``; LATTICE's)
against ``genmmrec_tpu.ops.graph``, on the CPU, where the top-k is K3's
plain version: values within 1e-6, the kept columns by index, and the
gradient through the per-step top-k against ``jax.grad`` through
``lax.top_k`` (rtol 1e-5, atol 1e-6 of the largest)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genmmrec_tpu.ops import graph as jg
from genmmrec_tpu_torch.ops import graph as tg


def _feats(n=300, d=24, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def test_build_sim_matches():
    f = _feats()
    f[7] = 0.0  # a zero row: normalized by 1e-12, a zero row and column
    ref = np.asarray(jg.build_sim(jnp.asarray(f)))
    got = tg.build_sim(torch.from_numpy(f)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    assert not got[7].any() and not got[:, 7].any()


@pytest.mark.parametrize("norm", ["sym", "rw", "none"])
def test_norm_laplacian_dense_matches(norm):
    """The three norms on a sparse non-negative plane with an empty row,
    and their gradients through a random cotangent."""
    rng = np.random.default_rng(1)
    adj = (rng.random((200, 200)) * (rng.random((200, 200)) < 0.05)).astype(np.float32)
    adj[11] = 0.0
    g_bar = rng.standard_normal(adj.shape).astype(np.float32)
    ref = np.asarray(jg.norm_laplacian_dense(jnp.asarray(adj), norm))
    a = torch.from_numpy(adj).requires_grad_()
    got = tg.norm_laplacian_dense(a, norm)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-6, atol=1e-7)
    assert not got[11].any()
    (got * torch.from_numpy(g_bar)).sum().backward()
    ref_g = np.asarray(jax.grad(lambda x: (jg.norm_laplacian_dense(x, norm) * g_bar).sum())(jnp.asarray(adj)))
    # JAX's power of a zero row sum leaves NaN in that row's gradient; the
    # port takes the power of the positive sums only
    rows = np.arange(200) != 11
    np.testing.assert_allclose(a.grad.numpy()[rows], ref_g[rows], rtol=1e-5, atol=1e-6 * np.abs(ref_g[rows]).max())
    assert np.isfinite(a.grad.numpy()).all()


def test_norm_laplacian_dense_rejects_an_unknown_norm():
    with pytest.raises(ValueError):
        tg.norm_laplacian_dense(torch.zeros(3, 3), "row")


@pytest.mark.parametrize("k", [1, 10, 37])
def test_knn_graph_dense_matches(k):
    """``knn_graph_dense(build_sim(f), k)`` in the three norms: the planes
    within 1e-6 and each row's kept columns equal to ``lax.top_k``'s."""
    f = _feats(seed=k)
    sim_j = jg.build_sim(jnp.asarray(f))
    sim_t = tg.build_sim(torch.from_numpy(f))
    for norm in ("sym", "rw", "none"):
        ref = np.asarray(jg.knn_graph_dense(sim_j, k, norm))
        got = tg.knn_graph_dense(sim_t, k, norm).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(got != 0, ref != 0)
    assert ((got != 0).sum(1) == k).all()


def test_dense_topk_plane_ties_take_the_lower_index():
    """Rows of equal values: the kept columns are ``lax.top_k``'s, the lower
    index first among ties."""
    rng = np.random.default_rng(2)
    sim = rng.integers(0, 4, (64, 90)).astype(np.float32)
    _, idx = jax.lax.top_k(jnp.asarray(sim), 10)
    ref = np.zeros_like(sim)
    np.put_along_axis(ref, np.asarray(idx), 1.0, axis=1)
    got = tg.dense_topk_plane(torch.from_numpy(sim) + 1.0, 10).numpy() != 0
    np.testing.assert_array_equal(got, ref != 0)


def test_per_step_topk_gradient_matches_jax():
    """The learned graph's top-k with a gradient (LATTICE's step: the
    similarity of projected features, the kept values, the "sym" norm):
    the gradient into the projection against ``jax.grad`` through
    ``lax.top_k``, and it reaches the similarity at the kept entries only."""
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((250, 40)).astype(np.float32)
    w = (rng.standard_normal((16, 40)) * 0.3).astype(np.float32)
    g_bar = rng.standard_normal((250, 250)).astype(np.float32)

    def jax_plane(w):
        sim = jg.build_sim(jnp.asarray(feats) @ w.T)
        vals, idx = jax.lax.top_k(sim, 10)
        adj = jnp.zeros_like(sim).at[jnp.arange(sim.shape[0])[:, None], idx].set(vals)
        return jg.norm_laplacian_dense(adj, "sym")

    ref = np.asarray(jax_plane(jnp.asarray(w)))
    ref_g = np.asarray(jax.grad(lambda w: (jax_plane(w) * g_bar).sum())(jnp.asarray(w)))
    wt = torch.from_numpy(w).requires_grad_()
    sim = tg.build_sim(torch.from_numpy(feats) @ wt.T)
    sim.retain_grad()
    got = tg.norm_laplacian_dense(tg.dense_topk_plane(sim, 10), "sym")
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-5, atol=1e-7)
    (got * torch.from_numpy(g_bar)).sum().backward()
    np.testing.assert_allclose(wt.grad.numpy(), ref_g, rtol=1e-5, atol=1e-6 * np.abs(ref_g).max())
    assert ((sim.grad != 0) == (got != 0)).all()
