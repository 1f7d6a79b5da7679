"""The port's KNN item graphs, device k-means and interest debiasing
against the JAX package, on the CPU.

- ``knn_graph_sparse`` in its three normalizations: rows and columns equal
  (ties to the lower index in both), values within 1e-6 relative (the two
  packages normalize the features and sum the similarities in their own
  order);
- k-means: torch's draws cannot be JAX's, so the test rebuilds the JAX
  package's k-means++ seeding from its key and hands the centers to the
  port's Lloyd iterations: the labels must be equal and the inertia within
  1e-5 relative; the port's own seeding is held to quality on separable
  blobs, as the JAX package's test holds its own;
- the debias tables and ``interest_debias`` with JAX's sample plane
  injected: equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genmmrec_tpu.common import interest_cluster as jic
from genmmrec_tpu.ops.graph import knn_graph_sparse as j_knn
from genmmrec_tpu_torch.common import interest_cluster as tic
from genmmrec_tpu_torch.ops import graph as tgraph


def _t(a):
    return torch.from_numpy(np.array(a))


def _blobs(n_per=60, k=5, d=16, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0.0, 8.0, (k, d))
    x = np.concatenate([centers[i] + rng.normal(0.0, 0.3, (n_per, d)) for i in range(k)])
    return x.astype(np.float32), np.repeat(np.arange(k), n_per)


def _purity(labels, truth):
    return sum(np.unique(truth[labels == c], return_counts=True)[1].max() for c in np.unique(labels)) / len(labels)


# -- KNN item graphs ------------------------------------------------------
def _features(n=300, d=32, seed=0):
    f = np.abs(np.random.default_rng(seed).normal(0.0, 0.3, (n, d))).astype(np.float32)
    f[7] = f[3]  # a duplicated item: a tie that both packages break by index
    f[11] = f[3]
    return f


@pytest.mark.parametrize("norm_type", ["sym", "rw", "binary_row"])
def test_knn_graph_sparse_matches_jax(norm_type):
    f = _features()
    ref = j_knn(f, 10, norm_type)
    got = tgraph.knn_graph_sparse(_t(f), 10, norm_type)
    np.testing.assert_array_equal(got.rows.numpy(), np.asarray(ref.rows))
    np.testing.assert_array_equal(got.cols.numpy(), np.asarray(ref.cols))
    np.testing.assert_allclose(got.vals.numpy(), np.asarray(ref.vals), rtol=1e-6, atol=0)
    assert got.nnz == 3000 and got.n_rows == got.n_cols == 300 and not got.symmetric
    assert torch.equal(got.row_ptr, torch.arange(0, 3001, 10, dtype=torch.int32))


def test_knn_graph_sparse_blocks_and_norm_names(monkeypatch):
    """Blocks of 64 rows, the last one ragged, give the one-block graph;
    an unknown normalization raises."""
    f = _t(_features(n=200, seed=1))
    whole = tgraph.knn_graph_sparse(f, 7, "sym")
    monkeypatch.setattr(tgraph, "KNN_BLOCK", 64)
    blocked = tgraph.knn_graph_sparse(f, 7, "sym")
    for field in ("rows", "cols", "vals", "row_ptr"):
        assert torch.equal(getattr(blocked, field), getattr(whole, field)), field
    with pytest.raises(ValueError, match="norm_type"):
        tgraph.knn_graph_sparse(f, 7, "none")


# -- k-means -------------------------------------------------------------
def _jax_seeds(key, x, k):
    """The centers of ``_kmeans_single``'s k-means++ seeding under ``key``,
    its loop replayed step by step."""
    n = x.shape[0]
    k_first, kk = jax.random.split(key)
    first = jax.random.randint(k_first, (), 0, n)
    centers = [x[first]]
    mind = ((x - x[first]) ** 2).sum(-1)
    for _ in range(1, k):
        kk, k_sel = jax.random.split(kk)
        probs = mind / jnp.maximum(mind.sum(), 1e-12)
        c = x[jax.random.choice(k_sel, n, p=probs)]
        centers.append(c)
        mind = jnp.minimum(mind, ((x - c) ** 2).sum(-1))
    return np.asarray(jnp.stack(centers))


@pytest.mark.parametrize(
    "case", ["blobs", "gaussian", "duplicates"]
)
def test_lloyd_from_jax_seeds_matches(case):
    """From the JAX package's own initial centers, the port's Lloyd steps
    reach the same labels and inertia as ``_kmeans_single``. 'duplicates'
    has fewer distinct points than clusters (k clamps to n at tiny): the
    seeding then draws row 0 from all-zero distances."""
    rng = np.random.default_rng(2)
    if case == "blobs":
        x, k = _blobs(n_per=40, k=4, d=8, seed=3)[0], 4
    elif case == "gaussian":
        x, k = rng.standard_normal((300, 16)).astype(np.float32), 7
    else:
        x, k = np.repeat(rng.standard_normal((3, 4)).astype(np.float32), 2, axis=0), 6
    key = jax.random.PRNGKey(5)
    xj = jnp.asarray(x)
    labels, inertia = jic._kmeans_single(key, xj, k=k)
    seeds = _jax_seeds(key, xj, k)
    t_labels, t_inertia = tic.kmeans_single(_t(x), k, centers=_t(seeds))
    np.testing.assert_array_equal(t_labels.numpy(), np.asarray(labels))
    np.testing.assert_allclose(float(t_inertia), float(inertia), rtol=1e-5, atol=1e-6)


def test_kmeans_pp_seeding_with_zero_distances():
    """k at or above the number of distinct points: the port's own seeding
    takes row 0 once every distance is 0, as ``jax.random.choice`` does,
    where ``torch.multinomial`` would raise."""
    x = _t(np.repeat(np.eye(3, dtype=np.float32), 2, axis=0))
    seeds = tic.kmeans_pp_seeds(x, 5, torch.Generator().manual_seed(0))
    assert {tuple(r) for r in seeds[:3].tolist()} == {tuple(r) for r in np.eye(3).tolist()}
    assert torch.equal(seeds[3], x[0]) and torch.equal(seeds[4], x[0])
    labels, inertia = tic.kmeans_single(x, 5, torch.Generator().manual_seed(0))
    assert float(inertia) == 0.0 and labels.shape == (6,)


def test_kmeans_fit_recovers_blobs():
    x, truth = _blobs()
    labels, inertia = tic.kmeans_fit(_t(x), 5, n_init=10, seed=0)
    assert labels.shape == truth.shape and _purity(labels.numpy(), truth) == 1.0
    assert inertia < 1000.0
    _, j_inertia = jic.kmeans_fit(x, 5, n_init=10, seed=0)
    assert inertia == pytest.approx(j_inertia, rel=1e-4)


def test_standardize_and_auto_k_rule(monkeypatch):
    """The float64 standardization equals the JAX package's; the auto-k
    rule, fed the JAX package's inertia for each k, picks its k."""
    x = _blobs(n_per=40, k=4, d=8, seed=7)[0]
    ref = jic.MultimodalCluster()._standardize(np.asarray(x, np.float64)).astype(np.float32)
    got = tic.MultimodalCluster.standardize(_t(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2.0**-22)
    opts = dict(use_auto_optimal_k=True, kmeans_cluster_num_min=2, kmeans_cluster_num_max=11, kmeans_stride=2)
    j_k = jic.MultimodalCluster(**opts).get_kmeans_cluster_optimal_num(ref)
    monkeypatch.setattr(tic, "kmeans_fit", lambda f, k, **kw: (None, jic.kmeans_fit(f.numpy(), k, **kw)[1]))
    assert tic.MultimodalCluster(**opts).get_kmeans_cluster_optimal_num(_t(ref)) == j_k


# -- debiasing -------------------------------------------------------------
@pytest.fixture(scope="module")
def tables():
    rng = np.random.default_rng(9)
    n_users, n_items = 40, 90
    # the last user has no interaction
    users, items = rng.integers(0, n_users - 1, 400), rng.integers(0, n_items, 400)
    users[:3] = 0  # a user with a repeated interaction
    items[:3] = 5
    img, txt = rng.integers(0, 6, n_items), rng.integers(0, 11, n_items)
    img[0], txt[0] = 5, 10  # every label present
    jt = jic.build_debias_tables(users, items, n_users, img, txt)
    tt = tic.build_debias_tables(_t(users), _t(items), n_users, _t(img), _t(txt))
    return jt, tt, n_users, n_items


def test_build_debias_tables_matches(tables):
    jt, tt, n_users, _ = tables
    for name in ("img_member", "txt_member", "txt_counts", "txt_minfreq", "img_labels", "txt_labels"):
        np.testing.assert_array_equal(tt[name].numpy(), np.asarray(jt[name]), err_msg=name)
    assert (tt["txt_minfreq"] == 0).any()  # a user without interactions


@pytest.mark.parametrize("ratio", [0.1, 1.0])
def test_interest_debias_matches_with_jax_draws(tables, ratio):
    jt, tt, n_users, n_items = tables
    rng = np.random.default_rng(10)
    users = rng.integers(0, n_users, 24)
    origin = (rng.random((24, n_items)) < 0.1).astype(np.float32)
    generated = np.where(rng.random((24, n_items)) < 0.2, 1.0 - origin, origin).astype(np.float32)
    key = jax.random.PRNGKey(11)
    ref = jic.interest_debias(key, jnp.asarray(users), jnp.asarray(origin), jnp.asarray(generated), jt, ratio)
    sampled = _t(jax.random.uniform(key, (24, n_items)) < ratio)
    got = tic.interest_debias(_t(users), _t(origin), _t(generated), tt, ratio, sampled=sampled)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    if ratio == 1.0:
        assert (got.numpy() != generated).any()
