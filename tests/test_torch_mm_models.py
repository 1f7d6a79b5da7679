"""The port's first multimodal models (VBPR, BM3, FREEDOM, ItemKNNCBF)
against the JAX package, on the CPU.

Each model runs on the tiny tier widened to 200 users x 600 items, with the
JAX initial parameters copied in by name (``from_jax_params``). Held: the
graphs built at construction (edges equal, values within 1e-6), FREEDOM's
``pre_epoch`` with the JAX uniforms injected, ``full_embeddings`` and the
scores (1e-5 relative), the loss (1e-5) and every gradient against
``jax.grad`` (1e-4 of an element plus 1e-5 of its tensor's largest: float32
summation order), BM3's dropout masks rebuilt from the JAX keys
(``bernoulli(k, p)`` is ``uniform(k) < p``), and ItemKNNCBF's
``scores_matrix`` (1e-5 relative).
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
from genmmrec_tpu_torch.data.arrays import build_eval_data as t_eval
from genmmrec_tpu_torch.data.arrays import build_train_data as t_train
from genmmrec_tpu_torch.data.dataset import RecDataset as TDataset
from genmmrec_tpu_torch.engine.evaluator import group_masks
from genmmrec_tpu_torch.engine.trainer import Trainer as TTrainer
from genmmrec_tpu_torch.interop import from_jax_params, jax_tree_by_name, params_by_jax_name
from genmmrec_tpu_torch.models import get_model as t_get_model

CPU = torch.device("cpu")
MODELS = ["VBPR", "BM3", "FREEDOM"]
SLICE = {
    "synthetic_n_users": 200,
    "synthetic_n_items": 600,
    "synthetic_n_inters": 3000,
    "train_batch_size": 64,
    "save_recommended_topk": False,
    "mesh_shape": {"data": 1, "model": 1},
}


# gradients that are zero but for rounding, and the weight of their layer:
# FREEDOM's projection biases add the same term to the positive and the
# negative score, which cancels in their difference. Both packages' values
# must stay below 1e-5 of that weight's largest gradient.
ZERO_GRADS = {"FREEDOM": {"image_trs/b": "image_trs/w", "text_trs/b": "text_trs/w"}}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t.to(dtype) if dtype else t


def _below(key, shape, p):
    """``jax.random.bernoulli(key, p, shape)`` as a bool tensor."""
    return _t(np.asarray(jax.random.uniform(key, shape)) < np.float32(p))


@pytest.fixture(scope="module", params=MODELS)
def pair(request):
    """One model in both packages on the same data, with the same parameters."""
    name = request.param
    jc, tc = JConfig(name, "tiny", dict(SLICE)), TConfig(name, "tiny", dict(SLICE))
    j_splits, t_splits = JDataset(jc).split(), TDataset(tc).split()
    jtd, ttd = j_train(j_splits[0]), t_train(t_splits[0], CPU)
    jm, tm = j_get_model(name)(jc, jtd), t_get_model(name)(tc, ttd)
    assert type(tm).__name__ == name
    params = jm.init_params(jax.random.PRNGKey(0))
    from_jax_params(tm, _np_tree(params))
    jstate, tstate = jm.init_state(jax.random.PRNGKey(1)), tm.init_state()
    return dict(name=name, jc=jc, tc=tc, t_splits=t_splits, ttd=ttd, jm=jm, tm=tm, params=params,
                jstate=jstate, tstate=tstate)


def _batch(n_users, n_items, B=96, seed=0):
    rng = np.random.default_rng(seed)
    w = np.ones(B, np.float32)
    w[-7:] = 0.0
    return rng.integers(0, n_users, B), rng.integers(0, n_items, B), rng.integers(0, n_items, B), w


def _assert_graph(got, rows, cols, vals):
    np.testing.assert_array_equal(got.rows.numpy(), np.asarray(rows))
    np.testing.assert_array_equal(got.cols.numpy(), np.asarray(cols))
    np.testing.assert_allclose(got.vals.numpy(), np.asarray(vals), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got.row_ptr.numpy(), np.searchsorted(np.asarray(rows), np.arange(got.n_rows + 1)))


def test_parameters_and_graphs_match(pair):
    """The parameter names and values, then what each model builds at
    construction: VBPR's raw features (text then vision), BM3's adjacency,
    FREEDOM's static edge layout and permutation, its degree weights, its
    full-graph values and its merged item graph."""
    name, jm, tm = pair["name"], pair["jm"], pair["tm"]
    ref, got = jax_tree_by_name(_np_tree(pair["params"])), params_by_jax_name(tm)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    np.testing.assert_array_equal(tm.item_raw_features.numpy(), np.asarray(jm.item_raw_features))
    if name == "VBPR":
        assert tm.item_raw_features.shape[1] == 16 + 32
        np.testing.assert_array_equal(ref["item_linear/b"], 0.0)
    if name == "BM3":
        g = jm.norm_adj
        _assert_graph(tm.norm_adj, g.rows, g.cols, g.vals)
        assert tm.norm_adj.symmetric
    if name == "FREEDOM":
        ui = tm.ui
        assert ui.n_edges == jm.n_edges and ui.structure.symmetric
        np.testing.assert_array_equal(ui.structure.rows.numpy(), np.asarray(jm.adj_rows))
        np.testing.assert_array_equal(ui.structure.cols.numpy(), np.asarray(jm.adj_cols))
        np.testing.assert_array_equal(ui.perm.numpy(), np.asarray(jm._perm))
        np.testing.assert_array_equal(ui.users.numpy(), np.asarray(jm.ui_users))
        np.testing.assert_array_equal(ui.items.numpy(), np.asarray(jm.ui_items))
        np.testing.assert_allclose(ui.edge_values.numpy(), np.asarray(jm.edge_values), rtol=1e-6)
        np.testing.assert_allclose(pair["tstate"]["masked_vals"].numpy(), np.asarray(pair["jstate"]["masked_vals"]),
                                   rtol=1e-6, atol=1e-7)
        g = jm.mm_adj
        _assert_graph(tm.mm_adj, g.rows, g.cols, g.vals)
        # the union of two graphs of knn_k edges a row
        assert tm.mm_adj.nnz == 2 * jm.n_items * jm.knn_k and not tm.mm_adj.symmetric


@pytest.mark.parametrize("pair", ["FREEDOM"], indirect=True)
@pytest.mark.parametrize("epoch", [0, 1])
def test_freedom_pre_epoch_matches(pair, epoch):
    """FREEDOM's degree-sensitive pruning from the JAX uniforms: the same
    pairs kept and the same re-normalized values; its own draw keeps as
    many."""
    jm, tm = pair["jm"], pair["tm"]
    key = jax.random.PRNGKey(30 + epoch)
    ref = np.asarray(jm.pre_epoch(pair["params"], pair["jstate"], key, epoch)["masked_vals"])
    uniform = _t(np.asarray(jax.random.uniform(key, (jm.n_edges,))))
    got = tm.pre_epoch(pair["tstate"], None, epoch, uniform=uniform)["masked_vals"].numpy()
    np.testing.assert_array_equal(got != 0, ref != 0)
    assert (ref != 0).sum() == 2 * int(jm.n_edges * (1.0 - jm.dropout))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    drawn = tm.pre_epoch(pair["tstate"], torch.Generator().manual_seed(epoch), epoch)["masked_vals"]
    assert int((drawn != 0).sum()) == (ref != 0).sum()


def _state(pair):
    """The state both models train with: FREEDOM's pruned graph of one JAX draw."""
    jm, tm = pair["jm"], pair["tm"]
    if pair["name"] != "FREEDOM":
        return pair["jstate"], pair["tstate"]
    key = jax.random.PRNGKey(40)
    jstate = jm.pre_epoch(pair["params"], pair["jstate"], key, 0)
    uniform = _t(np.asarray(jax.random.uniform(key, (jm.n_edges,))))
    return jstate, tm.pre_epoch(pair["tstate"], None, 0, uniform=uniform)


def test_embeddings_and_scores_match(pair):
    jm, tm, params = pair["jm"], pair["tm"], pair["params"]
    ref = jm.full_embeddings(params, pair["jstate"])
    with torch.no_grad():
        got = tm.full_embeddings(pair["tstate"])
        users = torch.arange(0, jm.n_users, 3)
        scores = tm.scores_cached(pair["tstate"], users, got).numpy()
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)
    ref_scores = np.asarray(jm.scores(params, pair["jstate"], jnp.asarray(users.numpy(), jnp.int32)))
    np.testing.assert_allclose(scores, ref_scores, rtol=1e-5, atol=1e-5 * np.abs(ref_scores).max())


def test_loss_and_grads_match(pair):
    """The loss and every gradient against ``jax.grad``, BM3's four dropout
    masks rebuilt from the JAX keys."""
    name, jm, tm, params = pair["name"], pair["jm"], pair["tm"], pair["params"]
    jstate, tstate = _state(pair)
    users, pos, neg, w = _batch(jm.n_users, jm.n_items)
    jb = {"users": jnp.asarray(users, jnp.int32), "pos": jnp.asarray(pos, jnp.int32),
          "neg": jnp.asarray(neg, jnp.int32), "weight": jnp.asarray(w)}
    key = jax.random.PRNGKey(7)
    (ref, _), grads = jax.value_and_grad(jm.loss, has_aux=True)(params, jstate, jb, key)
    tb = {"users": _t(users), "pos": _t(pos), "neg": _t(neg), "weight": _t(w)}
    extra = {}
    if name == "BM3":
        p, d = 1.0 - jm.dropout, jm.embedding_dim
        shapes = {"user": (jm.n_users, d), "item": (jm.n_items, d), "text": (jm.n_items, d), "image": (jm.n_items, d)}
        keys = dict(zip(("user", "item", "text", "image"), jax.random.split(key, 4)))
        extra["keep"] = {m: _below(keys[m], shapes[m], p) for m in shapes}
    tm.zero_grad(set_to_none=True)
    total, parts = tm.loss(tstate, tb, **extra)
    total.backward()
    np.testing.assert_allclose(total.item(), float(ref), rtol=1e-5)
    assert len(parts) == 1 and parts[0] is total
    ref_g = jax_tree_by_name(_np_tree(grads))
    got = dict(zip(params_by_jax_name(tm), (p.grad for _, p in tm.named_parameters())))
    assert got.keys() == ref_g.keys()
    for k, g in got.items():
        if k in ZERO_GRADS.get(name, {}):
            bound = 1e-5 * np.abs(ref_g[ZERO_GRADS[name][k]]).max()
            assert max(np.abs(ref_g[k]).max(), g.abs().max().item()) <= bound, k
            continue
        scale = np.abs(ref_g[k]).max()
        np.testing.assert_allclose(g.numpy(), ref_g[k], rtol=1e-4, atol=1e-5 * scale, err_msg=k)
    tm.zero_grad(set_to_none=True)


def test_bm3_draws_its_own_dropout_and_trains_without_negatives():
    tc = TConfig("BM3", "tiny", {"dropout": 0.5, "save_recommended_topk": False})
    td = t_train(TDataset(tc).split()[0], CPU)
    tm = t_get_model("BM3")(tc, td)
    tm.init_params(torch.Generator().manual_seed(0))
    dropped = tm._drop(torch.ones(200, 64), torch.Generator().manual_seed(1), None)
    assert set(dropped.unique().tolist()) == {0.0, 2.0} and abs((dropped == 0).float().mean().item() - 0.5) < 0.03
    users, pos, neg, w = _batch(td.n_users, td.n_items, B=32)
    batch = {"users": _t(users), "pos": _t(pos), "neg": _t(neg), "weight": _t(w)}
    a = tm.loss({}, batch, torch.Generator().manual_seed(2))[0]
    b = tm.loss({}, batch, torch.Generator().manual_seed(2))[0]
    c = tm.loss({}, batch, torch.Generator().manual_seed(3))[0]
    assert a.item() == b.item() != c.item()
    assert not bool(tc["use_neg_sampling"]) and not TTrainer(tc, tm).use_neg


@pytest.mark.parametrize("name", ["VBPR", "BM3", "FREEDOM", "ItemKNNCBF"])
def test_fit_on_tiny(name, tmp_path):
    """``get_model`` + ``Trainer.fit`` end to end on tiny: finite losses and
    a result for every metric; BM3 trains its copies of the feature tables;
    ItemKNNCBF trains nothing."""
    tc = TConfig(name, "tiny", {"epochs": 2, "save_recommended_topk": False, "checkpoint_dir": str(tmp_path)})
    tr, va, te = TDataset(tc).split()
    td = t_train(tr, CPU)
    tc["pop_mask"], tc["warm_mask"] = group_masks(tr, CPU)
    model = t_get_model(name)(tc, td)
    trainer = TTrainer(tc, model)
    score, valid, test = trainer.fit(td, t_eval(va, tr, 64, CPU), t_eval(te, tr, 64, CPU), verbose=False)
    assert len(trainer.train_loss_dict) == 2 and all(np.isfinite(v) for v in trainer.train_loss_dict.values())
    assert 0.0 < score <= 1.0 and "Coverage@50" in test and "recall@20" in valid
    if name == "BM3":
        assert not torch.equal(model.image_embedding, model.v_feat)
        assert not torch.equal(model.text_embedding, model.t_feat)
    if name == "ItemKNNCBF":
        assert model.dummy_embeddings.tolist() == [0.5, 0.5] and set(trainer.train_loss_dict.values()) == {0.0}


@pytest.mark.parametrize("overrides", [{}, {"knn_k": 3, "shrink": 0.0}, {"knn_k": 700}], ids=["yaml", "k3_noshrink", "k_past_n"])
def test_itemknncbf_scores_matrix_matches(overrides):
    """``R @ S`` from the device blocks and K3's top-k against the JAX
    package's host ``argpartition``; a ``knn_k`` past the catalog keeps every
    item."""
    over = {**SLICE, **overrides}
    jc, tc = JConfig("ItemKNNCBF", "tiny", dict(over)), TConfig("ItemKNNCBF", "tiny", dict(over))
    jtd, ttd = j_train(JDataset(jc).split()[0]), t_train(TDataset(tc).split()[0], CPU)
    jm, tm = j_get_model("ItemKNNCBF")(jc, jtd), t_get_model("ItemKNNCBF")(tc, ttd)
    ref, got = np.asarray(jm.scores_matrix), tm.scores_matrix.numpy()
    assert got.shape == ref.shape == (jm.n_users, jm.n_items) and (ref > 0).any()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6 * np.abs(ref).max())
    users = torch.arange(5)
    np.testing.assert_array_equal(tm.scores({}, users).numpy(), got[:5])
