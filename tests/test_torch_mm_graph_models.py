"""The port's last eight multimodal graph models (GUME, LATTICE, MGCN,
LGMRec, SMORE, PGL, SLMRec, DAMRS) against the JAX package, on the CPU.

Each model runs on the tiny tier widened to 200 users x 600 items, with
the JAX initial parameters copied in by name (``from_jax_params``). Held:
the graphs each model builds and their values (1e-6; LATTICE's dense
planes too), ``full_embeddings`` and the scores (rtol 1e-5, atol 1e-5 of
the largest), the loss (1e-5) and every gradient against ``jax.grad``
(rtol 1e-4, atol 1e-5 of the tensor's largest: float32 summation order; a
parameter the loss does not read has no gradient in the port and a zero
one in JAX), with every JAX draw rebuilt from its key and injected
(``bernoulli(k, p)`` is ``uniform(k) < p``).

DAMRS's graphs tie: the JAX package takes its top-k by ``argpartition``,
whose choice among equal values is its own. Its masked modal graphs are
held by each row's neighbour set where the row's k-th and (k+1)-th
similarities differ, its co-occurrence graph by each row's sorted counts
and the neighbours above the row's least count; for the model comparisons
the port takes the JAX package's three item graphs, in its order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genmmrec_tpu.config import Config as JConfig
from genmmrec_tpu.data.arrays import build_train_data as j_train
from genmmrec_tpu.data.dataset import RecDataset as JDataset
from genmmrec_tpu.models import get_model as j_get_model
from genmmrec_tpu_torch.config import Config as TConfig
from genmmrec_tpu_torch.data.arrays import build_train_data as t_train
from genmmrec_tpu_torch.data.dataset import RecDataset as TDataset
from genmmrec_tpu_torch.interop import from_jax_params, jax_tree_by_name, params_by_jax_name
from genmmrec_tpu_torch.models import get_model as t_get_model
from genmmrec_tpu_torch.ops.graph import sorted_graph

CPU = torch.device("cpu")
MODELS = ["GUME", "LATTICE", "MGCN", "LGMRec", "SMORE", "PGL", "SLMRec", "DAMRS"]
SLICE = {
    "synthetic_n_users": 200,
    "synthetic_n_items": 600,
    "synthetic_n_inters": 3000,
    "train_batch_size": 64,
    "save_recommended_topk": False,
    "mesh_shape": {"data": 1, "model": 1},
}
# the parameters no loss term reads, as in the reference
UNREAD = {
    "SLMRec": {"g_a_iva/w", "g_a_iva/b"},
    "SLMRec_FD": {f"{h}/{p}" for h in ("g_i_iv", "g_v_iv", "g_iv_iva", "g_a_iva", "g_iva_ivat", "g_t_ivat")
                  for p in "wb"},
}
# gradients that are zero but for rounding, and the weight of their layer:
# a bias added to every row of the second view of SLMRec's in-batch
# cross-entropy shifts each row's logits by one constant, which the softmax
# cancels. Both packages' values must stay below 1e-5 of that weight's
# largest gradient.
ZERO_GRADS = {"SLMRec": {"g_v_iv/b": "g_v_iv/w", "g_t_ivat/b": "g_t_ivat/w"}}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t.to(dtype) if dtype else t


def _u(key, shape):
    return np.asarray(jax.random.uniform(key, shape))


def _build(name, overrides=None):
    over = {**SLICE, **(overrides or {})}
    jc, tc = JConfig(name, "tiny", dict(over)), TConfig(name, "tiny", dict(over))
    jtd, ttd = j_train(JDataset(jc).split()[0]), t_train(TDataset(tc).split()[0], CPU)
    return j_get_model(name)(jc, jtd), t_get_model(name)(tc, ttd)


def _as_port_graph(g):
    """A JAX SparseGraph as the port's, in the JAX edge order (row-sorted)."""
    return sorted_graph(_t(g.rows), _t(g.cols), _t(g.vals), g.n_rows, g.n_cols)


# the first layer of the modal attention (MGCN's query, GUME's separation):
# at the JAX initialization its inputs are so small that the two modal
# rows' tanh slopes nearly cancel in its bias gradient (1e-11 against 1e-9
# for the weight). Both packages get the same wider layer, so the bias
# gradient is compared where it is not a cancellation.
WIDENED = {"MGCN": "query1", "GUME": "separate1"}


def _widened(name, params):
    if name not in WIDENED:
        return params
    layer = dict(params[WIDENED[name]])
    layer["w"] = layer["w"] * 30.0
    layer["b"] = jax.random.normal(jax.random.PRNGKey(9), layer["b"].shape) * 0.5
    return {**params, WIDENED[name]: layer}


def _pair(name, overrides=None):
    jm, tm = _build(name, overrides)
    assert type(tm).__name__ == name
    if name == "DAMRS":
        for g in ("image_adj", "text_adj", "session_adj"):
            setattr(tm, g, _as_port_graph(getattr(jm, g)))
    params = _widened(name, jm.init_params(jax.random.PRNGKey(0)))
    from_jax_params(tm, _np_tree(params))
    jstate, tstate = jm.init_state(jax.random.PRNGKey(1)), tm.init_state()
    return dict(name=name, jm=jm, tm=tm, params=params, jstate=jstate, tstate=tstate)


@pytest.fixture(scope="module", params=MODELS)
def pair(request):
    """One model in both packages on the same data, with the same parameters."""
    return _pair(request.param)


def _graph_equal(tg, jg, symmetric=None):
    np.testing.assert_array_equal(tg.rows.numpy(), np.asarray(jg.rows))
    np.testing.assert_array_equal(tg.cols.numpy(), np.asarray(jg.cols))
    np.testing.assert_allclose(tg.vals.numpy(), np.asarray(jg.vals), rtol=1e-6, atol=1e-7)
    assert (tg.n_rows, tg.n_cols) == (jg.n_rows, jg.n_cols)
    if symmetric is not None:
        assert tg.symmetric == symmetric


def _knn_equal(tg, jg):
    """KNN graphs: each row's (column, value) pairs equal, values within
    1e-6. Two neighbours of near-equal similarity may stand in the other
    order in a row: each side ranks its own float32 similarity product."""
    np.testing.assert_array_equal(tg.rows.numpy(), np.asarray(jg.rows))
    by_col = lambda rows, cols: np.lexsort((cols, rows))
    t_order = by_col(tg.rows.numpy(), tg.cols.numpy())
    j_order = by_col(np.asarray(jg.rows), np.asarray(jg.cols))
    np.testing.assert_array_equal(tg.cols.numpy()[t_order], np.asarray(jg.cols)[j_order])
    np.testing.assert_allclose(tg.vals.numpy()[t_order], np.asarray(jg.vals)[j_order], rtol=1e-6, atol=1e-7)


def test_parameters_and_graphs_match(pair):
    """Parameter names and values carried across; the graphs each model
    builds at construction, edges equal and values within 1e-6."""
    name, jm, tm = pair["name"], pair["jm"], pair["tm"]
    ref, got = jax_tree_by_name(_np_tree(pair["params"])), params_by_jax_name(tm)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    if name in ("GUME", "MGCN", "SMORE"):
        _knn_equal(tm.image_original_adj, jm.image_original_adj)
        _knn_equal(tm.text_original_adj, jm.text_original_adj)
        _graph_equal(tm.norm_adj, jm.norm_adj, symmetric=name != "GUME")
        _graph_equal(tm.R, jm.R, symmetric=False)
    if name == "GUME":
        np.testing.assert_array_equal(tm.ii_rows.numpy(), jm._ii_rows)
        np.testing.assert_array_equal(tm.ii_cols.numpy(), jm._ii_cols)
        assert len(jm._ii_rows) > 50
    if name == "SMORE":
        assert (jm.image_knn_k, jm.text_knn_k) == (40, 15)
        _graph_equal(tm.fusion_adj, jm.fusion_adj)
    if name == "LATTICE":
        _graph_equal(tm.norm_adj, jm.norm_adj, symmetric=False)
        for g in ("image_original_adj", "text_original_adj"):
            np.testing.assert_allclose(getattr(tm, g).numpy(), np.asarray(getattr(jm, g)), rtol=1e-6, atol=1e-7)
            assert int((getattr(tm, g) != 0).sum(1).min()) == jm.knn_k
    if name in ("LGMRec", "DAMRS", "SLMRec"):
        _graph_equal(tm.norm_adj, jm.norm_adj, symmetric=True)
    if name == "LGMRec":
        _graph_equal(tm.adj, jm.adj, symmetric=False)
        np.testing.assert_allclose(tm.inv_inters_u.numpy(), np.asarray(jm.inv_inters_u), rtol=1e-6)
    if name == "PGL":
        np.testing.assert_array_equal(tm.ui.structure.rows.numpy(), np.asarray(jm.adj_rows))
        np.testing.assert_array_equal(tm.ui.structure.cols.numpy(), np.asarray(jm.adj_cols))
        _graph_equal(tm.mm_adj, jm.mm_adj)
        np.testing.assert_allclose(pair["tstate"]["sub_vals"].numpy(), np.asarray(pair["jstate"]["sub_vals"]),
                                   rtol=1e-6, atol=1e-7)


def test_gume_common_pairs_as_a_set():
    """GUME's item pairs common to both KNN lists, built on the device from
    the two graphs' columns, against ``np.intersect1d`` row by row over the
    port's own graphs (a pair set, self pairs left out)."""
    _, tm = _build("GUME")
    k, n = tm.knn_k, tm.n_items
    img = tm.image_original_adj.cols.numpy().reshape(n, k)
    txt = tm.text_original_adj.cols.numpy().reshape(n, k)
    ref = {(i, int(j)) for i in range(n) for j in np.intersect1d(img[i], txt[i]) if j != i}
    got = set(zip(tm.ii_rows.tolist(), tm.ii_cols.tolist()))
    assert got == ref and len(got) == len(tm.ii_rows)
    assert all(i != j for i, j in got)


def _masked_sims(tm):
    v = tm.v_feat.numpy().astype(np.float32)
    t = tm.t_feat.numpy().astype(np.float32)
    vn = v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-12)
    tn = t / np.maximum(np.linalg.norm(t, axis=1, keepdims=True), 1e-12)
    vs, ts = vn @ vn.T, tn @ tn.T
    mask = (vs < vs.mean()) | (ts < ts.mean())
    vs[mask] = 0
    ts[mask] = 0
    return vs, ts


def _sorted_and_strict(nbrs, w):
    """Each row's weights sorted descending, and each row's set of
    neighbours whose weight is above the row's least."""
    return -np.sort(-w, axis=1), [frozenset(n[x > x.min()].tolist()) for n, x in zip(nbrs, w)]


def test_damrs_graphs_match_jax():
    """DAMRS's masked modal graphs (K3 on the device) against the JAX
    package's ``argpartition``: the same neighbour set on every row whose
    k-th and (k+1)-th similarities differ, and the same values; its session
    graph (the within-user co-occurrence, no ``item_graph_dict`` file)
    against the JAX numpy build: each row's self loop first, its sorted
    counts and the neighbours above its least count equal (counts tie)."""
    jm, tm = _build("DAMRS")
    k, n = tm.knn_k, tm.n_items
    sims = _masked_sims(tm)
    for g, name, sim in ((tm.image_adj, "image_adj", sims[0]), (tm.text_adj, "text_adj", sims[1])):
        jg = getattr(jm, name)
        np.testing.assert_array_equal(g.rows.numpy(), np.asarray(jg.rows))
        np.testing.assert_allclose(g.vals.numpy(), np.asarray(jg.vals), rtol=1e-6)
        top = -np.sort(-sim, axis=1)
        clear = top[:, k - 1] > top[:, k]
        got = np.sort(g.cols.numpy().reshape(n, k), axis=1)
        ref = np.sort(np.asarray(jg.cols).reshape(n, k), axis=1)
        assert clear.sum() > 0.9 * n
        np.testing.assert_array_equal(got[clear], ref[clear])
    # the co-occurrence counts, as the JAX package's fallback takes them
    users, items = tm.data.users.numpy(), tm.data.items.numpy()
    R = np.zeros((tm.n_users, n), np.float32)
    np.add.at(R, (users, items), 1.0)
    co = R.T @ R
    np.fill_diagonal(co, 0)

    def neighbours(g):
        rows, cols = np.asarray(g.rows), np.asarray(g.cols)
        ptr = np.searchsorted(rows, np.arange(n + 1))
        lists = [cols[ptr[i] : ptr[i + 1]] for i in range(n)]
        assert all(len(c) and c[0] == i for i, c in enumerate(lists))
        return [c[1:] for c in lists]

    got, ref = neighbours(tm.session_adj), neighbours(jm.session_adj)
    assert [len(c) for c in got] == [len(c) for c in ref]
    full = np.array([len(c) == k for c in ref])
    as_rows = lambda lists: (np.stack([c for c, f in zip(lists, full) if f]),
                             np.stack([co[i, c] for i, (c, f) in enumerate(zip(lists, full)) if f]))
    got_sorted, got_strict = _sorted_and_strict(*as_rows(got))
    ref_sorted, ref_strict = _sorted_and_strict(*as_rows(ref))
    np.testing.assert_array_equal(got_sorted, ref_sorted)
    assert got_strict == ref_strict
    for i in np.flatnonzero(~full):
        assert set(got[i].tolist()) == set(ref[i].tolist()), i
    tied = sum((w == w.min()).sum() > 1 for w in as_rows(got)[1])
    assert tied > 10 and full.sum() > 100


def test_damrs_session_graph_from_file(tmp_path):
    """An ``item_graph_dict`` file (ragged neighbour lists, an item without
    one): both packages read the same edges and values."""
    rng = np.random.default_rng(5)
    d = {}
    for i in range(600):
        if i % 7 == 3:
            continue
        m = int(rng.integers(1, 15))
        d[i] = (rng.integers(0, 600, m).tolist(), rng.random(m).tolist())
    (tmp_path / "tiny").mkdir()
    np.save(tmp_path / "tiny" / "item_graph_dict_2.npy", d, allow_pickle=True)
    jm, tm = _build("DAMRS", {"data_path": str(tmp_path)})
    _graph_equal(tm.session_adj, jm.session_adj)


def _eval_draws(pair):
    """LGMRec draws at evaluation too, from the JAX package's fixed key."""
    if pair["name"] != "LGMRec":
        return {}
    return {"draws": _lgmrec_draws(pair["jm"], jax.random.PRNGKey(0))}


def test_embeddings_and_scores_match(pair):
    jm, tm, params = pair["jm"], pair["tm"], pair["params"]
    ref = jm.full_embeddings(params, pair["jstate"]) if pair["name"] != "SLMRec" else jm.compute(params)
    with torch.no_grad():
        if pair["name"] == "SLMRec":
            got = tm.eval_artifacts(pair["tstate"])
        else:
            got = tm.full_embeddings(pair["tstate"], **_eval_draws(pair))
        users = torch.arange(0, jm.n_users, 3)
        scores = tm.scores_cached(pair["tstate"], users, got).numpy()
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5, atol=1e-5 * np.abs(r).max())
    ref_scores = np.asarray(jm.scores(params, pair["jstate"], jnp.asarray(users.numpy(), jnp.int32)))
    np.testing.assert_allclose(scores, ref_scores, rtol=1e-5, atol=1e-5 * np.abs(ref_scores).max())


def _lgmrec_draws(jm, key):
    ks = jax.random.split(key, 8)
    shapes = [(jm.n_items, jm.hyper_num), (jm.n_users, jm.hyper_num)] * 2
    return dict(gumbel=tuple(_t(_u(ks[i], s)) for i, s in enumerate(shapes)),
                keep=tuple(_t(_u(ks[4 + i], s) < np.float32(jm.keep_rate)) for i, s in enumerate(shapes)))


def _slmrec_draws(jm, key):
    N, d, L = jm.n_users + jm.n_items, jm.latent_dim, jm.n_layers
    keep = lambda k: _t(_u(k, (N, d)) < np.float32(1.0 - jm.dropout_rate))
    if jm.ssl_task == "FD":
        views = tuple(
            tuple(tuple(keep(kk) for kk in jax.random.split(jax.random.fold_in(kv, j), L)) for j in range(3))
            for kv in jax.random.split(key)
        )
        return {"keep": views}
    k_sel, k_d = jax.random.split(key)
    idx1, idx2 = jm._fm_draw(k_sel, 3)
    out = {"fm_idx": (_t(np.asarray(idx1)), _t(np.asarray(idx2)))}
    if jm.ssl_task == "FD+FM":
        out["keep"] = tuple(
            tuple(tuple(keep(jax.random.fold_in(k_d, (j * 2 + v) * L + li)) for li in range(L)) for j in range(3))
            for v in range(2)
        )
    return out


def _draws(name, jm, key, B):
    """The keyword arguments of the port's ``loss`` that carry the JAX
    draws of ``key``."""
    if name == "GUME":
        k1, k2 = jax.random.split(key)
        shape = (jm.n_users, jm.embedding_dim)
        return {"noise": tuple(_t(_u(kk, shape)) for k in (k1, k2) for kk in jax.random.split(k))}
    if name == "SMORE":
        shape = (jm.n_users + jm.n_items, jm.embedding_dim)
        return {"keep": tuple(_t(_u(k, shape) < np.float32(1.0 - jm.dropout_rate)) for k in jax.random.split(key, 3))}
    if name == "LGMRec":
        return {"draws": _lgmrec_draws(jm, key)}
    if name == "PGL":
        shape = (B, 2 * jm.embedding_dim)
        return {"keep": tuple(_t(_u(k, shape) < np.float32(1.0 - jm.dropout)) for k in jax.random.split(key, 4))}
    if name == "SLMRec" and jm.ssl_task != "FAC":
        return {"draws": _slmrec_draws(jm, key)}
    return {}


def _batch(n_users, n_items, B=96, seed=0):
    rng = np.random.default_rng(seed)
    w = np.ones(B, np.float32)
    w[-7:] = 0.0
    return rng.integers(0, n_users, B), rng.integers(0, n_items, B), rng.integers(0, n_items, B), w


def _state(pair):
    """PGL trains on a graph pruned by one JAX draw; the others on their
    initial state."""
    if pair["name"] != "PGL":
        return pair["jstate"], pair["tstate"]
    key = jax.random.PRNGKey(40)
    jstate = pair["jm"].pre_epoch(pair["params"], pair["jstate"], key, 0)
    tstate = pair["tm"].pre_epoch(pair["tstate"], None, 0, uniform=_t(_u(key, (pair["jm"].n_edges,))))
    return jstate, tstate


def _check_loss_and_grads(pair, unread_key=None):
    name, jm, tm, params = pair["name"], pair["jm"], pair["tm"], pair["params"]
    jstate, tstate = _state(pair)
    users, pos, neg, w = _batch(jm.n_users, jm.n_items)
    jb = {"users": jnp.asarray(users, jnp.int32), "pos": jnp.asarray(pos, jnp.int32),
          "neg": jnp.asarray(neg, jnp.int32), "weight": jnp.asarray(w)}
    key = jax.random.PRNGKey(7)
    (ref, _), grads = jax.value_and_grad(jm.loss, has_aux=True)(params, jstate, jb, key)
    tb = {"users": _t(users), "pos": _t(pos), "neg": _t(neg), "weight": _t(w)}
    tm.zero_grad(set_to_none=True)
    total, parts = tm.loss(tstate, tb, **_draws(name, jm, key, len(users)))
    total.backward()
    np.testing.assert_allclose(total.item(), float(ref), rtol=1e-5)
    assert len(parts) == 1 and parts[0] is total
    ref_g = jax_tree_by_name(_np_tree(grads))
    got = dict(zip(params_by_jax_name(tm), (p.grad for _, p in tm.named_parameters())))
    assert got.keys() == ref_g.keys()
    unread = {k for k, g in got.items() if g is None}
    zero = ZERO_GRADS.get(name, {}) if tm.__dict__.get("ssl_task", "FAC") == "FAC" else {}
    for k, g in got.items():
        if g is None:
            assert not ref_g[k].any(), k
            continue
        if k in zero:
            bound = 1e-5 * np.abs(ref_g[zero[k]]).max()
            assert max(np.abs(ref_g[k]).max(), g.abs().max().item()) <= bound, k
            continue
        scale = np.abs(ref_g[k]).max()
        np.testing.assert_allclose(g.numpy(), ref_g[k], rtol=1e-4, atol=1e-5 * scale, err_msg=k)
    assert unread == UNREAD.get(unread_key or name, set())
    tm.zero_grad(set_to_none=True)


def test_loss_and_grads_match(pair):
    """The loss and every gradient against ``jax.grad``, the draws injected."""
    _check_loss_and_grads(pair)


@pytest.mark.parametrize("task", ["FD", "FM", "FD+FM"])
def test_slmrec_ssl_tasks_match(task):
    """SLMRec's other SSL tasks: FD (dropout on every layer of two views),
    FM (two distinct modalities masked, crossed accumulation) and FD+FM,
    with the JAX dropout planes and ``_fm_draw``'s pair injected."""
    pair = _pair("SLMRec", {"ssl_task": task})
    _check_loss_and_grads(pair, "SLMRec_FD")


def test_slmrec_draws_its_own():
    """Without injected draws SLMRec takes them from the generator: FM's
    two indices distinct, FD's planes at the keep rate; the same seed
    gives the same loss."""
    _, tm = _build("SLMRec", {"ssl_task": "FD+FM"})
    tm.init_params(torch.Generator().manual_seed(0))
    for s in range(20):
        i1, i2 = tm.draws(torch.Generator().manual_seed(s))["fm_idx"]
        assert int(i1) != int(i2) and 0 <= min(int(i1), int(i2)) and max(int(i1), int(i2)) < 3
    keep = tm.draws(torch.Generator().manual_seed(1))["keep"]
    share = torch.stack([m.float().mean() for v in keep for t in v for m in t])
    assert len(share) == 2 * 3 * tm.n_layers and ((share - 0.7).abs() < 0.01).all()
    users, pos, neg, w = _batch(tm.n_users, tm.n_items, B=32)
    batch = {"users": _t(users), "pos": _t(pos), "neg": _t(neg), "weight": _t(w)}
    a, b, c = (tm.loss({}, batch, torch.Generator().manual_seed(s))[0].item() for s in (2, 2, 3))
    assert a == b != c and np.isfinite(a)


@pytest.mark.parametrize("epoch", [0, 1])
def test_pgl_pre_epoch_matches(epoch):
    """PGL's local mode: 30% of the unique pairs by Gumbel top-k from the
    JAX uniforms, the same pairs kept and the same re-normalized values."""
    jm, tm = _build("PGL")
    params = jm.init_params(jax.random.PRNGKey(0))
    jstate, tstate = jm.init_state(jax.random.PRNGKey(1)), tm.init_state()
    key = jax.random.PRNGKey(60 + epoch)
    ref = np.asarray(jm.pre_epoch(params, jstate, key, epoch)["sub_vals"])
    got = tm.pre_epoch(tstate, None, epoch, uniform=_t(_u(key, (jm.n_edges,))))["sub_vals"].numpy()
    np.testing.assert_array_equal(got != 0, ref != 0)
    assert (ref != 0).sum() == 2 * int(jm.n_edges * 0.3)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def test_pgl_global_mode_matches():
    """PGL's global mode: the thresholded SVD subgraph by the same ``svds``
    call on the host. Held as dense planes: the same entries kept and their
    values within 1e-6, leaving out the entries within 1e-6 of the 1e-3
    threshold; then the loss and every gradient on that graph."""
    pair = _pair("PGL", {"mode": "global"})
    jm, tm = pair["jm"], pair["tm"]
    N = jm.n_users + jm.n_items

    def dense(g):
        m = np.zeros((N, N), np.float64)
        m[np.asarray(g.rows), np.asarray(g.cols)] = np.asarray(g.vals)
        return m

    got, ref = dense(tm.sub_graph), dense(jm.sub_graph)
    assert (ref != 0).sum() > 1000
    far = np.abs(np.abs(ref) - 1e-3) > 1e-6
    far &= np.abs(np.abs(got) - 1e-3) > 1e-6
    np.testing.assert_array_equal((got != 0)[far], (ref != 0)[far])
    np.testing.assert_allclose(got[far], ref[far], rtol=0, atol=1e-6)
    tm.sub_graph = _as_port_graph(jm.sub_graph)
    _check_loss_and_grads(pair)


def test_lattice_learned_graph_matches():
    """LATTICE's learned item graph of a step (the per-step top-k through
    K3's plain version, the softmax modal weights, the "sym" norm, the
    ``lambda_coeff`` blend) against the JAX one, and its gradient into the
    projections and ``modal_weight`` through a random cotangent."""
    pair = _pair("LATTICE")
    jm, tm, params = pair["jm"], pair["tm"], pair["params"]
    g_bar = np.random.default_rng(3).standard_normal((jm.n_items, jm.n_items)).astype(np.float32)
    ref = np.asarray(jm._learned_item_adj(params))
    ref_g = jax_tree_by_name(_np_tree(jax.grad(lambda p: (jm._learned_item_adj(p) * g_bar).sum())(params)))
    tm.zero_grad(set_to_none=True)
    adj = tm.learned_item_adj()
    np.testing.assert_allclose(adj.detach().numpy(), ref, rtol=1e-5, atol=1e-7)
    (adj * _t(g_bar)).sum().backward()
    got = {k: p.grad for k, p in zip(params_by_jax_name(tm), tm.parameters())}
    for k in ("modal_weight", "image_trs/w", "image_trs/b", "text_trs/w", "text_trs/b"):
        scale = np.abs(ref_g[k]).max()
        assert scale > 0, k
        np.testing.assert_allclose(got[k].numpy(), ref_g[k], rtol=1e-4, atol=1e-5 * scale, err_msg=k)
    tm.zero_grad(set_to_none=True)


def test_gume_extended_id_override():
    """``forward``'s ``extended_id_override`` replaces the id tower's output,
    as the JAX argument does."""
    pair = _pair("GUME")
    jm, tm, params = pair["jm"], pair["tm"], pair["params"]
    over = np.random.default_rng(4).standard_normal((jm.n_users + jm.n_items, jm.embedding_dim)).astype(np.float32)
    ref = np.asarray(jm.forward(params, extended_id_override=jnp.asarray(over)))
    with torch.no_grad():
        got = tm.forward(extended_id_override=_t(over)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("name", ["LATTICE", "SLMRec"])
def test_quick_start_on_tiny(name, tmp_path, monkeypatch):
    """``quick_start`` on tiny on the CPU, one epoch: finite losses and a
    result for every metric."""
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


def test_smore_spectrum_gradient_at_dc_and_nyquist():
    """SMORE's spectral filters at d = 64: the gradient into the three
    complex weights against ``jax.grad`` and against a float64 central
    difference of the port's function. ``irfft`` drops the imaginary parts
    of the DC bin and of the Nyquist bin (d even), so their derivative is
    0: both frameworks give exactly 0 there."""
    pair = _pair("SMORE")
    jm, tm, params = pair["jm"], pair["tm"], pair["params"]
    d = jm.embedding_dim
    rng = np.random.default_rng(6)
    img, txt = (rng.standard_normal((50, d)).astype(np.float32) for _ in range(2))
    g_bar = [rng.standard_normal((50, d)).astype(np.float32) for _ in range(3)]
    names = [f"{m}_complex_weight" for m in ("image", "text", "fusion")]

    def jax_loss(p):
        return sum((c * g).sum() for c, g in zip(jm._spectrum(p, jnp.asarray(img), jnp.asarray(txt)), g_bar))

    ref_g = jax.grad(jax_loss)(params)
    tm.zero_grad(set_to_none=True)
    out = tm._spectrum(_t(img), _t(txt))
    sum((c * _t(g)).sum() for c, g in zip(out, g_bar)).backward()
    tm64 = {n: getattr(tm, n).detach().double() for n in names}

    def port_loss64(weights):
        x_img, x_txt = _t(img).double(), _t(txt).double()
        c = lambda w: torch.view_as_complex(w.contiguous())
        fi, ft = torch.fft.rfft(x_img, dim=1, norm="ortho"), torch.fft.rfft(x_txt, dim=1, norm="ortho")
        back = lambda z: torch.fft.irfft(z, n=d, dim=1, norm="ortho")
        outs = (back(fi * c(weights[names[0]])), back(ft * c(weights[names[1]])), back(ft * fi * c(weights[names[2]])))
        return sum((o * _t(g).double()).sum() for o, g in zip(outs, g_bar)).item()

    for n in names:
        got = getattr(tm, n).grad.numpy()
        ref = np.asarray(ref_g[n])
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5 * np.abs(ref).max(), err_msg=n)
        for j in (0, d // 2):
            assert got[0, j, 1] == 0.0 and ref[0, j, 1] == 0.0, (n, j)
            for part in (0, 1):
                e = torch.zeros_like(tm64[n])
                e[0, j, part] = 1e-6
                fd = (port_loss64({**tm64, n: tm64[n] + e}) - port_loss64({**tm64, n: tm64[n] - e})) / 2e-6
                assert abs(fd - got[0, j, part]) <= 1e-4 * max(1.0, abs(fd)), (n, j, part, fd, got[0, j, part])
    tm.zero_grad(set_to_none=True)
