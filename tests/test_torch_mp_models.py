"""The port's message-passing models (MMGCN, GRCN, DualGNN, DRAGON, COHESION,
MVGAE) against the JAX package, on the CPU.

Each model runs on the tiny tier widened to 200 users x 600 items, with the
JAX initial parameters copied in by name (``from_jax_params``). Held: the
message-passing graphs and their values (1e-6), the KNN item graphs and
COHESION's pruned values from the JAX uniforms, ``full_embeddings`` and the
scores (rtol 1e-5, atol 1e-5 of the largest), the loss (1e-5) and every
gradient against ``jax.grad`` (rtol 1e-4, atol 1e-5 of the tensor's
largest: float32 summation order; a parameter the loss does not read has no
gradient in the port and a zero one in JAX), MVGAE's twelve dropout planes
and four normals rebuilt from the JAX keys.

The user co-occurrence graph (DualGNN, DRAGON, COHESION) ties often: the
port's (K3 over ``R @ Rᵀ`` on the device) is held against the JAX package's
(the native top-k and the numpy ``argpartition``) by each row's sorted
weights and by the set of neighbours whose weight is above the row's least,
and both packages read a ``user_graph_dict.npy`` the same way. For the
model comparisons the port takes the JAX package's neighbours, in its order.

MMGCN runs once more at MicroLens' feature widths (1,024 visual, 768
text): its text tower propagates the raw 768-wide features, past K1's 512
columns, so the port cuts them into a 512 and a 256 column slice.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genmmrec_tpu import native as j_native
from genmmrec_tpu.config import Config as JConfig
from genmmrec_tpu.data.arrays import build_train_data as j_train
from genmmrec_tpu.data.dataset import RecDataset as JDataset
from genmmrec_tpu.models import get_model as j_get_model
from genmmrec_tpu_torch.config import Config as TConfig
from genmmrec_tpu_torch.data.arrays import build_train_data as t_train
from genmmrec_tpu_torch.data.dataset import RecDataset as TDataset
from genmmrec_tpu_torch.interop import from_jax_params, jax_tree_by_name, params_by_jax_name
from genmmrec_tpu_torch.models import get_model as t_get_model
from genmmrec_tpu_torch.ops.graph import KERNEL_MAX_D, sorted_graph

CPU = torch.device("cpu")
MODELS = ["MMGCN", "GRCN", "DualGNN", "DRAGON", "COHESION", "MVGAE"]
USER_GRAPH_MODELS = ("DualGNN", "DRAGON", "COHESION")
# a model at a tier's feature widths: <model>@<tier>
WIDTHS = {"microlens": {"synthetic_v_feat_dim": 1024, "synthetic_t_feat_dim": 768}}
CASES = MODELS + ["MMGCN@microlens"]
SLICE = {
    "synthetic_n_users": 200,
    "synthetic_n_items": 600,
    "synthetic_n_inters": 3000,
    "train_batch_size": 64,
    "save_recommended_topk": False,
    "mesh_shape": {"data": 1, "model": 1},
}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t.to(dtype) if dtype else t


def _user_graph_from(jm, n_users):
    """The JAX model's user graph (neighbours and softmax weights, in its order) as the port's graph."""
    nbrs, w = np.asarray(jm.user_nbrs), np.asarray(jm.user_nbr_w)
    rows = np.repeat(np.arange(n_users), nbrs.shape[1])
    return sorted_graph(_t(rows), _t(nbrs.reshape(-1)), _t(w.reshape(-1)), n_users, n_users)


def _build(name, overrides=None):
    over = {**SLICE, **(overrides or {})}
    jc, tc = JConfig(name, "tiny", dict(over)), TConfig(name, "tiny", dict(over))
    jtd, ttd = j_train(JDataset(jc).split()[0]), t_train(TDataset(tc).split()[0], CPU)
    return j_get_model(name)(jc, jtd), t_get_model(name)(tc, ttd)


@pytest.fixture(scope="module", params=CASES)
def pair(request):
    """One model in both packages on the same data, with the same parameters."""
    name, _, tier = request.param.partition("@")
    jm, tm = _build(name, WIDTHS.get(tier))
    assert type(tm).__name__ == name
    if tier == "microlens":
        assert tm.v_feat.shape[1] == 1024 and tm.t_feat.shape[1] == 768 > KERNEL_MAX_D
    if name in USER_GRAPH_MODELS:
        tm.user_graph = _user_graph_from(jm, jm.n_users)
    params = jm.init_params(jax.random.PRNGKey(0))
    from_jax_params(tm, _np_tree(params))
    jstate, tstate = jm.init_state(jax.random.PRNGKey(1)), tm.init_state()
    return dict(name=name, jm=jm, tm=tm, params=params, jstate=jstate, tstate=tstate)


def _edges_equal(g, src, dst, vals=None):
    """A port message graph (rows = dst, cols = src) against JAX's dst-sorted edges."""
    np.testing.assert_array_equal(g.rows.numpy(), np.asarray(dst))
    np.testing.assert_array_equal(g.cols.numpy(), np.asarray(src))
    if vals is not None:
        np.testing.assert_allclose(g.vals.numpy(), np.asarray(vals), rtol=1e-6, atol=1e-7)


def test_parameters_and_graphs_match(pair):
    """Parameter names and values carried across; the graphs each model
    builds at construction, edges equal and values within 1e-6."""
    name, jm, tm = pair["name"], pair["jm"], pair["tm"]
    ref, got = jax_tree_by_name(_np_tree(pair["params"])), params_by_jax_name(tm)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    if name in ("MMGCN", "MVGAE"):
        _edges_equal(tm.graph, jm.src, jm.dst)
        assert tm.graph.symmetric and (tm.graph.vals == 1).all()
        if name == "MVGAE":
            assert int((tm.graph.rows == tm.graph.cols).sum()) == tm.N
    if name == "GRCN":
        _edges_equal(tm.graph, jm.src_s, jm.dst_s)
        np.testing.assert_array_equal(tm._perm_s.numpy(), np.asarray(jm._perm_s))
        np.testing.assert_array_equal(tm.src_d.numpy(), np.asarray(jm.src_d))
        np.testing.assert_array_equal(tm.dst_d.numpy(), np.asarray(jm.dst_d))
        order = np.argsort(np.asarray(jm.dst_d), kind="stable")
        _edges_equal(tm.directed, np.asarray(jm.src_d)[order], np.asarray(jm.dst_d)[order])
    if name in USER_GRAPH_MODELS and name != "COHESION":
        src, dst = np.asarray(jm.src_v), np.asarray(jm.dst_v)
        deg = np.bincount(dst, minlength=jm.N).astype(np.float32)
        ref_norm = np.asarray(
            (jnp.asarray(deg)[src] + 1e-12) ** -0.5 * (jnp.asarray(deg)[dst] + 1e-12) ** -0.5
        )
        _edges_equal(tm.graph, src, dst, ref_norm)
        assert tm.graph.symmetric
    if name in ("DRAGON", "COHESION"):
        g = jm.mm_adj
        _edges_equal(tm.mm_adj, np.asarray(g.cols), np.asarray(g.rows), np.asarray(g.vals))
        assert tm.mm_adj.nnz == 2 * jm.n_items * jm.knn_k
    if name == "COHESION":
        ui = tm.ui
        np.testing.assert_array_equal(ui.structure.rows.numpy(), np.asarray(jm.adj_rows))
        np.testing.assert_array_equal(ui.structure.cols.numpy(), np.asarray(jm.adj_cols))
        np.testing.assert_allclose(pair["tstate"]["masked_vals"].numpy(), np.asarray(pair["jstate"]["masked_vals"]),
                                   rtol=1e-6, atol=1e-7)


def _sorted_and_strict(nbrs, w):
    """Each row's weights sorted descending, and each row's set of
    neighbours whose weight is above the row's least."""
    order = -np.sort(-w, axis=1)
    strict = [frozenset(n[x > x.min()].tolist()) for n, x in zip(nbrs, w)]
    return order, strict


@pytest.mark.parametrize("jax_route", ["numpy", "native"])
def test_user_graph_matches_jax(jax_route, monkeypatch):
    """The port's co-occurrence top-40 against the JAX package's two ways to it, on the tiny
    slice where counts tie. Its numpy fallback sets a zero count to -inf, as
    the port does: each row's sorted weights within 1e-6 and the neighbours
    above the row's least weight equal. Its native top-k pads a user of
    fewer than 40 co-occurring users by repeating them (as the reference's
    preprocessing does): the same holds on the rows it does not pad, and on
    the others the port's neighbours of positive weight are the native
    row's distinct neighbours."""
    if jax_route == "numpy":
        monkeypatch.setattr(j_native, "cooccur_topk", lambda *a, **k: None)
    elif j_native.get_lib() is None:
        pytest.skip("the JAX package's native library is not built")
    jm, tm = _build("DualGNN")
    ref_n, ref_w = np.asarray(jm.user_nbrs), np.asarray(jm.user_nbr_w)
    g = tm.user_graph
    k = tm.k
    got_n, got_w = g.cols.numpy().reshape(-1, k), g.vals.numpy().reshape(-1, k)
    np.testing.assert_array_equal(g.rows.numpy(), np.repeat(np.arange(jm.n_users), k))
    full = (got_w > 0).sum(1) == k
    if jax_route == "native":
        for u in np.flatnonzero(~full):
            assert set(got_n[u][got_w[u] > 0].tolist()) == set(ref_n[u].tolist()) or not got_w[u].any(), u
    ref_sorted, ref_strict = _sorted_and_strict(ref_n[full], ref_w[full])
    got_sorted, got_strict = _sorted_and_strict(got_n[full], got_w[full])
    np.testing.assert_allclose(got_sorted, ref_sorted, rtol=1e-6, atol=1e-7)
    assert got_strict == ref_strict
    if jax_route == "numpy":
        ref_sorted, ref_strict = _sorted_and_strict(ref_n, ref_w)
        got_sorted, got_strict = _sorted_and_strict(got_n, got_w)
        np.testing.assert_allclose(got_sorted, ref_sorted, rtol=1e-6, atol=1e-7)
        assert got_strict == ref_strict
    # the slice has full rows tied at the 40th count, and rows of fewer
    # co-occurring users than 40
    tied = [(w == w.min()).sum() > 1 for w in got_w[full]]
    assert sum(tied) > 10 and (~full).sum() > 10
    # the weights are a softmax over the neighbours with a count
    np.testing.assert_allclose(got_w.sum(1)[got_w.sum(1) > 0], 1.0, rtol=1e-5)


def test_user_graph_from_file_matches(tmp_path):
    """A ``user_graph_dict.npy`` (ragged neighbour lists, a user without
    one, a list past k): both packages read the same neighbours and weights."""
    rng = np.random.default_rng(4)
    d = {}
    for u in range(200):
        if u == 3:
            continue
        n = 60 if u == 5 else int(rng.integers(1, 45))
        d[u] = (rng.integers(0, 200, n).tolist(), rng.integers(1, 9, n).astype(float).tolist())
    (tmp_path / "tiny").mkdir()
    np.save(tmp_path / "tiny" / "user_graph_dict.npy", d, allow_pickle=True)
    jm, tm = _build("DualGNN", {"data_path": str(tmp_path)})
    k = tm.k
    np.testing.assert_array_equal(tm.user_graph.cols.numpy().reshape(-1, k), np.asarray(jm.user_nbrs))
    w = tm.user_graph.vals.numpy().reshape(-1, k)
    np.testing.assert_allclose(w, np.asarray(jm.user_nbr_w), rtol=1e-6, atol=1e-7)
    assert (w[3] == 0).all()


@pytest.mark.parametrize("epoch", [0, 1])
def test_cohesion_pre_epoch_matches(epoch):
    """COHESION's degree-sensitive pruning (``dropout`` 0.3) from the JAX
    uniforms: the same pairs kept and the same re-normalized values; with
    ``dropout`` 0 (baby's) the full graph and no draw."""
    jm, tm = _build("COHESION", {"dropout": 0.3})
    params = jm.init_params(jax.random.PRNGKey(0))
    jstate, tstate = jm.init_state(jax.random.PRNGKey(1)), tm.init_state()
    key = jax.random.PRNGKey(50 + epoch)
    ref = np.asarray(jm.pre_epoch(params, jstate, key, epoch)["masked_vals"])
    uniform = _t(np.asarray(jax.random.uniform(key, (jm.n_edges,))))
    got = tm.pre_epoch(tstate, None, epoch, uniform=uniform)["masked_vals"].numpy()
    np.testing.assert_array_equal(got != 0, ref != 0)
    assert (ref != 0).sum() == 2 * int(jm.n_edges * 0.7)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    tm.dropout = 0.0
    full = tm.pre_epoch(tstate, None, epoch)["masked_vals"].numpy()
    np.testing.assert_allclose(full, np.asarray(jstate["masked_vals"]), rtol=1e-6, atol=1e-7)


def _mvgae_draws(jm, key):
    """MVGAE's draws from its loss key as the JAX model takes them: per
    tower four bool dropout planes, then the four normals."""
    k_f, k_z, k_v, k_t, k_c = jax.random.split(key, 5)
    shape = (jm.N, jm.dim_x)
    keep = {}
    for m, kt in zip(("v", "t", "c"), jax.random.split(k_f, 3)):
        keep[m] = tuple(_t(np.asarray(jax.random.uniform(kk, shape)) < np.float32(0.9))
                        for kk in jax.random.split(kt, 4))
    noise = {m: _t(np.asarray(jax.random.normal(kk, shape))) for m, kk in zip(("z", "v", "t", "c"),
                                                                             (k_z, k_v, k_t, k_c))}
    return {"keep": keep, "noise": noise}


def _batch(n_users, n_items, B=96, seed=0):
    rng = np.random.default_rng(seed)
    w = np.ones(B, np.float32)
    w[-7:] = 0.0
    return rng.integers(0, n_users, B), rng.integers(0, n_items, B), rng.integers(0, n_items, B), w


def test_embeddings_and_scores_match(pair):
    jm, tm, params = pair["jm"], pair["tm"], pair["params"]
    ref = jm.full_embeddings(params, pair["jstate"])
    with torch.no_grad():
        got = tm.full_embeddings(pair["tstate"])
        users = torch.arange(0, jm.n_users, 3)
        scores = tm.scores_cached(pair["tstate"], users, got).numpy()
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5, atol=1e-5 * np.abs(r).max())
    ref_scores = np.asarray(jm.scores(params, pair["jstate"], jnp.asarray(users.numpy(), jnp.int32)))
    np.testing.assert_allclose(scores, ref_scores, rtol=1e-5, atol=1e-5 * np.abs(ref_scores).max())


def _state(pair):
    """COHESION trains on a graph pruned by one JAX draw (``dropout`` 0.3 on
    a copy of the model); the others on their initial state."""
    jm, tm = pair["jm"], pair["tm"]
    if pair["name"] != "COHESION":
        return jm, tm, pair["jstate"], pair["tstate"]
    jm.dropout, tm.dropout = 0.3, 0.3
    key = jax.random.PRNGKey(40)
    jstate = jm.pre_epoch(pair["params"], pair["jstate"], key, 0)
    uniform = _t(np.asarray(jax.random.uniform(key, (jm.n_edges,))))
    tstate = tm.pre_epoch(pair["tstate"], None, 0, uniform=uniform)
    jm.dropout, tm.dropout = 0.0, 0.0
    return jm, tm, jstate, tstate


def test_loss_and_grads_match(pair):
    """The loss and every gradient against ``jax.grad``, the draws injected."""
    name, params = pair["name"], pair["params"]
    jm, tm, jstate, tstate = _state(pair)
    users, pos, neg, w = _batch(jm.n_users, jm.n_items)
    jb = {"users": jnp.asarray(users, jnp.int32), "pos": jnp.asarray(pos, jnp.int32),
          "neg": jnp.asarray(neg, jnp.int32), "weight": jnp.asarray(w)}
    key = jax.random.PRNGKey(7)
    (ref, _), grads = jax.value_and_grad(jm.loss, has_aux=True)(params, jstate, jb, key)
    tb = {"users": _t(users), "pos": _t(pos), "neg": _t(neg), "weight": _t(w)}
    extra = _mvgae_draws(jm, key) if name == "MVGAE" else {}
    tm.zero_grad(set_to_none=True)
    total, parts = tm.loss(tstate, tb, **extra)
    total.backward()
    np.testing.assert_allclose(total.item(), float(ref), rtol=1e-5)
    assert len(parts) == 1 and parts[0] is total
    ref_g = jax_tree_by_name(_np_tree(grads))
    got = dict(zip(params_by_jax_name(tm), (p.grad for _, p in tm.named_parameters())))
    assert got.keys() == ref_g.keys()
    unread = {k for k, g in got.items() if g is None}
    for k, g in got.items():
        if g is None:
            assert not ref_g[k].any(), k
            continue
        scale = np.abs(ref_g[k]).max()
        np.testing.assert_allclose(g.numpy(), ref_g[k], rtol=1e-4, atol=1e-5 * scale, err_msg=k)
    # the parameters no loss term reads, as in the reference
    expected_unread = {
        "DRAGON": {"weight_i"},
        "COHESION": {f"id_gcn/{p}" for p in ("preference", "mlp/w", "mlp/b", "mlp1/w", "mlp1/b")},
        "MVGAE": {f"{m}_gcn/{p}" for m in "vtc" for p in ("conv2/w", "conv2/b", "g2/w", "g2/b")},
    }
    assert unread == expected_unread.get(name, set())
    tm.zero_grad(set_to_none=True)


def test_mvgae_draws_its_own():
    """Without injected draws MVGAE takes every plane and normal from the
    generator: the same seed gives the same loss, another seed another."""
    _, tm = _build("MVGAE")
    tm.init_params(torch.Generator().manual_seed(0))
    users, pos, neg, w = _batch(tm.n_users, tm.n_items, B=32)
    batch = {"users": _t(users), "pos": _t(pos), "neg": _t(neg), "weight": _t(w)}
    keep, noise = tm.draws(torch.Generator().manual_seed(1))
    assert all(len(keep[m]) == 4 and keep[m][0].dtype == torch.bool for m in "vtc") and set(noise) == set("zvtc")
    share = torch.stack([k.float().mean() for m in "vtc" for k in keep[m]])
    assert ((share - 0.9).abs() < 0.01).all()
    a, b, c = (tm.loss({}, batch, torch.Generator().manual_seed(s))[0].item() for s in (2, 2, 3))
    assert a == b != c and np.isfinite(a)


@pytest.mark.parametrize("name", ["MMGCN", "DualGNN"])
def test_quick_start_on_tiny(name, tmp_path, monkeypatch):
    """``quick_start`` on tiny on the CPU, one epoch of each combination of
    the model's grid: finite losses and a result for every metric."""
    import logging

    from genmmrec_tpu_torch.quick_start import quick_start

    monkeypatch.chdir(tmp_path)
    root = logging.getLogger()
    handlers = list(root.handlers)
    try:
        combo, valid, test = quick_start(name, "tiny", {"save_recommended_topk": False}, save_model=False,
                                         max_epochs=1, device="cpu")
    finally:
        for h in list(root.handlers):
            root.removeHandler(h)
            if h not in handlers:
                h.close()
        for h in handlers:
            root.addHandler(h)
    assert 0.0 <= valid["recall@20"] <= 1.0 and "Coverage@50" in test
    assert all(np.isfinite(v) for v in list(valid.values()) + list(test.values()))
