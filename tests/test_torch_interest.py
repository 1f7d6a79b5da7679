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
  injected: equal;
- the spectral clustering of fused features (``multimodal_fusion_cluster``):
  its top-k sparsified, symmetrized plane equals the JAX function's (its
  loop, written out), its embedding equals sklearn's ``spectral_embedding``
  where the graph is connected, and its labels equal the JAX function's
  (sklearn's ``SpectralClustering``) up to a permutation on separable
  blobs.
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


def _jax_affinity(feats, sim_top_k):
    """The sparsified, symmetrized plane of the JAX package's
    ``multimodal_fusion_cluster`` (its loop, before the clustering)."""
    f = np.asarray(feats, np.float64)
    fn = f / np.maximum(np.linalg.norm(f, axis=1, keepdims=True), 1e-12)
    sim = fn @ fn.T
    n = sim.shape[0]
    for i in range(n):
        idx = np.argpartition(sim[i], -sim_top_k)[-sim_top_k:]
        mask = np.ones(n, bool)
        mask[idx] = False
        sim[i, mask] = 0
    return np.maximum(sim, sim.T)


@pytest.mark.parametrize("sim_top_k", [5, 20])
def test_fusion_affinity_matches_jax(sim_top_k):
    feats = np.random.default_rng(2).normal(size=(150, 24)).astype(np.float32)
    got = tic.MultimodalCluster(sim_top_k=sim_top_k).fusion_affinity(_t(feats)).numpy()
    np.testing.assert_allclose(got, _jax_affinity(feats, sim_top_k), rtol=1e-12, atol=1e-15)


def test_spectral_embedding_matches_sklearn_on_a_connected_graph():
    from sklearn.manifold import spectral_embedding as sk_embedding

    feats = np.random.default_rng(3).normal(size=(120, 8))
    sim = _jax_affinity(feats, 30)
    ref = sk_embedding(sim, n_components=4, drop_first=False, random_state=0)
    got = tic.spectral_embedding(_t(sim), 4).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("spread", [0.3, 3.0])
def test_multimodal_fusion_cluster_matches_sklearn_on_blobs(spread):
    """Tight and ten times wider blobs (the top-k graph falls apart into
    the blobs, so the eigenvectors of the zero eigenvalue are not unique):
    the port's labels are the JAX function's up to a permutation (adjusted
    Rand index 1)."""
    from sklearn.metrics import adjusted_rand_score

    rng = np.random.default_rng(0)
    centers = rng.normal(0.0, 8.0, (5, 16))
    x = np.concatenate([c + rng.normal(0.0, spread, (60, 16)) for c in centers]).astype(np.float32)
    ref = jic.MultimodalCluster(spectral_cluster_num=5, sim_top_k=20).multimodal_fusion_cluster(x)
    got = tic.MultimodalCluster(spectral_cluster_num=5, sim_top_k=20).multimodal_fusion_cluster(_t(x)).numpy()
    assert adjusted_rand_score(ref, got) == 1.0
    assert adjusted_rand_score(np.repeat(np.arange(5), 60), got) == 1.0
