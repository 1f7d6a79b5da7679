"""The port's diffusion recommenders (DiffRec, LD4MRec, DDRM, DiffGraph,
MCDRec, CoDMR) and the importance-sampling buffer against the JAX package,
on the CPU.

Each model runs on the tiny tier widened to 200 users x 600 items (MCDRec
with 20 diffusion steps, so that the JAX reference stays fast), with the
JAX initial parameters copied in by name (``from_jax_params``) and the
JAX state carried by ``from_jax_state``. Every JAX draw is rebuilt from its
key and injected (``bernoulli(k, p)`` is ``uniform(k) < p``).

Tolerances: forward values (embeddings, scores, the loss, the state the
loss writes, graph values) within 1e-5 of the tensor's largest entry
(1e-6 for graph values); gradients rtol 1e-4, atol 1e-5 of the tensor's
largest gradient. A parameter the loss reads only through a detached path
has no gradient in the port and a zero one in JAX. A convolution bias in
front of a batch norm (MCDRec's U-Net) has a gradient that is zero but for
rounding: both packages' stay below 1e-5 of the layer weight's largest.
Indices, edge sets, keep sets and counts must be equal.
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
from genmmrec_tpu.models.diffusion import importance as jimp
from genmmrec_tpu_torch.config import Config as TConfig
from genmmrec_tpu_torch.data.arrays import build_train_data as t_train
from genmmrec_tpu_torch.data.dataset import RecDataset as TDataset
from genmmrec_tpu_torch.interop import from_jax_params, from_jax_state, jax_tree_by_name, params_by_jax_name
from genmmrec_tpu_torch.models import get_model as t_get_model
from genmmrec_tpu_torch.models.codmr import DIFFUSIONS
from genmmrec_tpu_torch.models.diffusion import importance as timp

CPU = torch.device("cpu")
MODELS = ["DiffRec", "LD4MRec", "DDRM", "DiffGraph", "MCDRec", "CoDMR"]
SLICE = {
    "synthetic_n_users": 200,
    "synthetic_n_items": 600,
    "synthetic_n_inters": 3000,
    "train_batch_size": 64,
    "save_recommended_topk": False,
    "mesh_shape": {"data": 1, "model": 1},
}
OVERRIDES = {"MCDRec": {"steps": 20}}
# gradients that are zero but for rounding, and the weight of their layer
ZERO_GRADS = {
    "MCDRec": {f"unet/{blk}/{c}/b": f"unet/{blk}/{c}/w" for blk in ("enc1", "enc2", "dec1") for c in ("c1", "c2")},
}
# parameters read by the loss only through a detached path (or not at all)
UNREAD = {"LD4MRec": {"t_in"}, "CoDMR": {"user_emb_text", "item_text_net/w"}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run small products in many processes at once (``-n 6``):
    one torch thread each, for this module only, keeps their OpenMP pools
    from spinning against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t.to(dtype) if dtype else t


def _u(key, shape):
    return np.asarray(jax.random.uniform(key, shape))


def _keep(key, p, shape):
    return _t(_u(key, shape) < np.float32(p))


def _build(name):
    over = {**SLICE, **OVERRIDES.get(name, {})}
    jc, tc = JConfig(name, "tiny", dict(over)), TConfig(name, "tiny", dict(over))
    jtd, ttd = j_train(JDataset(jc).split()[0]), t_train(TDataset(tc).split()[0], CPU)
    return j_get_model(name)(jc, jtd), t_get_model(name)(tc, ttd)


@pytest.fixture(scope="module", params=MODELS)
def pair(request):
    """One model in both packages on the same data, with the same parameters
    and state."""
    name = request.param
    jm, tm = _build(name)
    assert type(tm).__name__ == name
    params = jax.jit(jm.init_params)(jax.random.PRNGKey(0))
    from_jax_params(tm, _np_tree(params))
    jstate = jm.init_state(jax.random.PRNGKey(1))
    out = dict(name=name, jm=jm, tm=tm, params=params, jstate=jstate, tstate=from_jax_state(tm, _np_tree(jstate)))
    if name == "LD4MRec":
        out["svd_emb"] = tm.user_svd_emb.numpy().copy()
        tm.user_svd_emb = _t(jm.user_svd_emb)
    return out


def _close(got, ref, rtol=1e-5, rel_atol=1e-5, msg=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rel_atol * max(np.abs(ref).max(), 1e-30), err_msg=msg)


def _graph_equal(tg, jg, symmetric=None):
    np.testing.assert_array_equal(tg.rows.numpy(), np.asarray(jg.rows))
    np.testing.assert_array_equal(tg.cols.numpy(), np.asarray(jg.cols))
    np.testing.assert_allclose(tg.vals.numpy(), np.asarray(jg.vals), rtol=1e-6, atol=1e-7)
    assert (tg.n_rows, tg.n_cols) == (jg.n_rows, jg.n_cols)
    if symmetric is not None:
        assert tg.symmetric == symmetric


def _knn_equal(tg, jg):
    """KNN graphs: each row's (column, value) pairs equal, values within 1e-6."""
    np.testing.assert_array_equal(tg.rows.numpy(), np.asarray(jg.rows))
    by_col = lambda rows, cols: np.lexsort((cols, rows))
    t_order = by_col(tg.rows.numpy(), tg.cols.numpy())
    j_order = by_col(np.asarray(jg.rows), np.asarray(jg.cols))
    np.testing.assert_array_equal(tg.cols.numpy()[t_order], np.asarray(jg.cols)[j_order])
    np.testing.assert_allclose(tg.vals.numpy()[t_order], np.asarray(jg.vals)[j_order], rtol=1e-6, atol=1e-7)


def test_parameters_state_and_graphs_match(pair):
    """Parameters and state carried across by name; the graphs and tables
    each model builds at construction."""
    name, jm, tm = pair["name"], pair["jm"], pair["tm"]
    ref, got = jax_tree_by_name(_np_tree(pair["params"])), params_by_jax_name(tm)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert pair["tstate"].keys() == pair["jstate"].keys()
    for k, v in pair["jstate"].items():
        np.testing.assert_array_equal(pair["tstate"][k].numpy(), np.asarray(v), err_msg=k)
    fresh = tm.init_state()
    for k, v in pair["jstate"].items():
        _close(fresh[k], v, rel_atol=1e-7, msg=k)
    if name == "DDRM":
        _graph_equal(tm.norm_adj, jm.norm_adj, symmetric=True)
    if name == "DiffGraph":
        np.testing.assert_array_equal(tm.graph.rows.numpy(), np.asarray(jm.dst))
        np.testing.assert_array_equal(tm.graph.cols.numpy(), np.asarray(jm.src))
        assert tm.graph.symmetric
    if name == "MCDRec":
        np.testing.assert_array_equal(tm.ui.structure.rows.numpy(), np.asarray(jm.adj_rows))
        np.testing.assert_array_equal(tm.ui.structure.cols.numpy(), np.asarray(jm.adj_cols))
    if name == "CoDMR":
        _graph_equal(tm.uiMat, jm.uiMat, symmetric=True)
        np.testing.assert_array_equal(tm.uinorm.numpy(), np.asarray(jm.uinorm))
        _knn_equal(tm.iciMat, jm.iciMat)
        _knn_equal(tm.icaiMat, jm.icaiMat)
    if name == "LD4MRec":
        # the same svds call on the same matrix; ARPACK's start vector moves
        # on from call to call in a process (two calls of one svds differ by
        # about 1e-4), so the model comparisons take the JAX table
        _close(pair["svd_emb"], jm.user_svd_emb, rel_atol=1e-3)
        top = np.abs(pair["svd_emb"]).argmax(0)
        assert (pair["svd_emb"][top, np.arange(top.shape[0])] > 0).all()
        _close(tm.user_mm_emb, jm.user_mm_emb)
        np.testing.assert_array_equal(tm.alpha_bar.numpy(), np.asarray(jm.alpha_bar))


def _batch(n_users, n_items, B=96, seed=0):
    rng = np.random.default_rng(seed)
    w = np.ones(B, np.float32)
    w[-7:] = 0.0
    users, pos, neg = rng.integers(0, n_users, B), rng.integers(0, n_items, B), rng.integers(0, n_items, B)
    jb = {"users": jnp.asarray(users, jnp.int32), "pos": jnp.asarray(pos, jnp.int32),
          "neg": jnp.asarray(neg, jnp.int32), "weight": jnp.asarray(w)}
    tb = {"users": _t(users), "pos": _t(pos), "neg": _t(neg), "weight": _t(w)}
    return jb, tb


def _draws(name, jm, jstate, key, B):
    """The keyword arguments of the port's ``loss`` that carry the JAX
    draws of ``key``."""
    if name == "DiffRec":
        k_t, k_n, k_d = jax.random.split(key, 3)
        ts, _ = jimp.sample_timesteps(k_t, jstate, B, "importance" if jm.reweight else "uniform")
        return dict(ts=_t(ts, torch.int64), noise=_t(jax.random.normal(k_n, (B, jm.n_items))),
                    keep=_keep(k_d, 1 - jm.dropout, (B, jm.n_items)))
    if name == "LD4MRec":
        k_t, k_n, k_d = jax.random.split(key, 3)
        probs = jnp.sqrt(jstate["loss_history"] ** 2)
        t = jax.random.categorical(k_t, jnp.log(probs / probs.sum()), shape=(B,))
        return dict(t=_t(t, torch.int64), noise=_t(jax.random.normal(k_n, (B, jm.n_items))),
                    keep=[_keep(jax.random.fold_in(k_d, i), 1 - jm.dropout, (B, jm.cnet_hidden))
                          for i in range(jm.cnet_layers)])
    if name == "DDRM":
        k_t, k_u, k_i = jax.random.split(key, 3)
        return dict(ts=_t(jax.random.randint(k_t, (B,), 0, jm.steps), torch.int64),
                    noise_u=_t(jax.random.normal(k_u, (B, jm.latent_dim))),
                    noise_i=_t(jax.random.normal(k_i, (B, jm.latent_dim))))
    if name == "DiffGraph":
        draws = []
        for k, n in zip(jax.random.split(key), (jm.n_users, jm.n_items)):
            k_t, k_n, k_d = jax.random.split(k, 3)
            draws.append((_t(jax.random.randint(k_t, (n,), 0, jm.steps), torch.int64),
                          _t(jax.random.normal(k_n, (n, jm.latdim))), _keep(k_d, 0.5, (n, jm.latdim))))
        return dict(draws=tuple(draws))
    if name == "MCDRec":
        k_t, k_n = jax.random.split(key)
        return dict(ts=_t(jax.random.randint(k_t, (B,), 0, jm.steps), torch.int64),
                    noise=_t(jax.random.normal(k_n, (B, jm.latent_dim))))
    if name == "CoDMR":
        draws = []
        for k, (domain, which) in zip(jax.random.split(key, 6), DIFFUSIONS):
            n = jm.n_users if domain == "txu" else jm.n_items
            k_t, k_n, k_d = jax.random.split(k, 3)
            keep = _t(np.asarray(jax.random.bernoulli(k_d, 0.5, (n, jm.hide_dim)))) if which == "non" else None
            draws.append((_t(jax.random.randint(k_t, (n,), 0, jm.steps), torch.int64),
                          _t(jax.random.normal(k_n, (n, jm.hide_dim))), keep))
        return dict(draws=draws)
    raise KeyError(name)


def _check_grads(name, tm, grads):
    ref = jax_tree_by_name(_np_tree(grads))
    got = dict(zip(params_by_jax_name(tm), (p.grad for _, p in tm.named_parameters())))
    assert got.keys() == ref.keys()
    zero = ZERO_GRADS.get(name, {})
    unread = set()
    for k, g in got.items():
        if g is None:
            assert not ref[k].any(), k
            unread.add(k)
            continue
        if k in zero:
            bound = 1e-5 * np.abs(ref[zero[k]]).max()
            assert max(np.abs(ref[k]).max(), g.abs().max().item()) <= bound, k
            continue
        np.testing.assert_allclose(g.numpy(), ref[k], rtol=1e-4, atol=1e-5 * np.abs(ref[k]).max(), err_msg=k)
    assert unread == UNREAD.get(name, set())
    tm.zero_grad(set_to_none=True)


def _ready_state(jm, seed=3):
    """A full loss history (every count at H): the importance proposal."""
    rng = np.random.default_rng(seed)
    steps, H = jm.steps, 10
    hist = rng.random((steps, H)).astype(np.float32) * np.linspace(0.1, 3.0, steps, dtype=np.float32)[:, None]
    return {"Lt_history": jnp.asarray(hist), "Lt_count": jnp.full((steps,), H, jnp.int32)}


def _loss_case(pair, jstate, tstate, key=7):
    name, jm, tm, params = pair["name"], pair["jm"], pair["tm"], pair["params"]
    jb, tb = _batch(jm.n_users, jm.n_items)
    key = jax.random.PRNGKey(key)
    stateful = name in ("DiffRec", "LD4MRec")
    fn = jm.loss_and_update if stateful else jm.loss
    (ref, aux), grads = jax.jit(jax.value_and_grad(fn, has_aux=True))(params, jstate, jb, key)
    kw = _draws(name, jm, jstate, key, len(tb["users"]))
    tm.zero_grad(set_to_none=True)
    if stateful:
        total, (parts, new_state) = tm.loss_and_update(tstate, tb, **kw)
        for k, v in aux[1].items():
            _close(new_state[k], v, msg=k)
        plain, _ = tm.loss(tstate, tb, **kw)
        assert plain.item() == total.item()
    else:
        total, parts = tm.loss(tstate, tb, **kw)
    total.backward()
    np.testing.assert_allclose(total.item(), float(ref), rtol=1e-5)
    assert len(parts) == 1 and parts[0] is total
    _check_grads(name, tm, grads)


def test_loss_and_grads_match(pair):
    """The loss (and the state it writes) and every gradient against
    ``jax.grad``, the draws injected."""
    _loss_case(pair, pair["jstate"], pair["tstate"])


@pytest.mark.parametrize("name", ["DiffRec"])
def test_diffrec_importance_loss_matches(name):
    """DiffRec on a full loss history: timesteps from the importance
    proposal, the loss divided by ``pt``, the ring written past full."""
    jm, tm = _build(name)
    params = jax.jit(jm.init_params)(jax.random.PRNGKey(0))
    from_jax_params(tm, _np_tree(params))
    jstate = _ready_state(jm)
    pair = dict(name=name, jm=jm, tm=tm, params=params)
    _loss_case(pair, jstate, from_jax_state(tm, _np_tree(jstate)), key=11)


def test_scores_match(pair):
    """Scores (DiffRec, LD4MRec: the chain or the one step over users'
    history rows; DDRM with the JAX package's fixed-key noise injected),
    embeddings and scores (DiffGraph, MCDRec), the reverse-chain
    artifacts (CoDMR, the fixed-key noise injected)."""
    name, jm, tm, params, jstate, tstate = (pair[k] for k in ("name", "jm", "tm", "params", "jstate", "tstate"))
    users = jnp.arange(0, jm.n_users, 3, dtype=jnp.int32)
    tu = _t(users, torch.int64)
    ref = np.asarray(jax.jit(jm.scores)(params, jstate, users))
    with torch.no_grad():
        if name == "DDRM":
            got = tm.scores(tstate, tu, noise=_t(jax.random.normal(jax.random.PRNGKey(0), (len(tu), jm.latent_dim))))
        elif name in ("DiffGraph", "MCDRec"):
            arts = tm.full_embeddings(tstate)
            for g, r in zip(arts, jax.jit(jm.full_embeddings)(params, jstate)):
                _close(g, r)
            got = tm.scores_cached(tstate, tu, arts)
        elif name == "CoDMR":
            noise = {side: _t(jax.random.normal(jax.random.PRNGKey(0), (n, jm.hide_dim)))
                     for side, n in (("items", jm.n_items), ("users", jm.n_users))}
            arts = tm.eval_artifacts(tstate, noise=noise)
            for g, r in zip(arts, jax.jit(jm.eval_artifacts)(params, jstate)):
                _close(g, r)
            got = tm.scores_cached(tstate, tu, arts)
        else:
            got = tm.scores(tstate, tu)
    _close(got, ref)


def test_ddrm_evaluation_draw_is_seeded():
    """DDRM's evaluation noise without injection: a generator seeded 0 for
    each chunk, so two calls agree and equal the injected draw."""
    _, tm = _build("DDRM")
    tm.init_params(torch.Generator().manual_seed(0))
    users = torch.arange(0, 64)
    with torch.no_grad():
        a, b = tm.scores(None, users), tm.scores(None, users)
        noise = torch.randn(64, tm.latent_dim, generator=torch.Generator().manual_seed(0))
        c = tm.scores(None, users, noise=noise)
    assert torch.equal(a, b) and torch.equal(a, c)


def _dgd(pair, key=40):
    jm, tm = pair["jm"], pair["tm"]
    key = jax.random.PRNGKey(key)
    k_x, k_loop, k_g = jax.random.split(key, 3)
    shape = (jm.n_items, jm.latent_dim)
    draws = dict(x=_t(jax.random.normal(k_x, shape)),
                 noise=torch.stack([_t(jax.random.normal(k, shape)) for k in jax.random.split(k_loop, jm.steps)]),
                 uniform=_t(_u(k_g, (jm.n_edges,))))
    jnew = jax.jit(lambda p, s, k: jm.pre_epoch(p, s, k, 0))(pair["params"], pair["jstate"], key)
    return jnew, tm.pre_epoch(pair["tstate"], None, 0, draws=draws)


def test_mcdrec_dgd_matches():
    """MCDRec's diffusion-guided graph denoising on the JAX draws: the keep
    set (``(1 - rho)`` of the pairs, ties at the threshold kept) equal and
    the re-normalized values within 1e-6."""
    name = "MCDRec"
    jm, tm = _build(name)
    params = jax.jit(jm.init_params)(jax.random.PRNGKey(0))
    from_jax_params(tm, _np_tree(params))
    jstate = jm.init_state(jax.random.PRNGKey(1))
    jnew, tnew = _dgd(dict(jm=jm, tm=tm, params=params, jstate=jstate, tstate=from_jax_state(tm, _np_tree(jstate))))
    got, ref = tnew["graph_vals"].numpy(), np.asarray(jnew["graph_vals"])
    np.testing.assert_array_equal(got > 0, ref > 0)
    assert (ref[: len(ref) // 2] > 0).sum() >= int(jm.n_edges * (1 - jm.rho))
    assert 0 < (ref == 0).sum()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


# ----------------------------------------------------------------------
def test_importance_ring_with_collisions():
    """``update_lt_state`` at B = 2,048 over 100 steps, H = 10 (about 20
    rows a timestep, so every ring wraps within the batch): the counts
    equal; a slot written once holds its row's loss; a slot written more
    than once holds one of its rows' losses, the last row's in batch
    order, which is also what XLA's CPU scatter keeps (bit-equal to the
    JAX package). Padding rows write nothing. Twice, the second from the
    first's state."""
    steps, H, B = 100, 10, 2048
    rng = np.random.default_rng(0)
    jstate, tstate = jimp.init_lt_state(steps, H), timp.init_lt_state(steps, H)
    for rnd in range(2):
        t = rng.integers(0, steps, B)
        losses = rng.random(B).astype(np.float32)
        w = np.ones(B, np.float32)
        w[-100:] = 0.0
        jstate = jimp.update_lt_state(jstate, jnp.asarray(t, jnp.int32), jnp.asarray(losses), jnp.asarray(w))
        count_before = tstate["Lt_count"].numpy().copy()
        tstate = timp.update_lt_state(tstate, _t(t), _t(losses), _t(w))
        np.testing.assert_array_equal(tstate["Lt_count"].numpy(), np.asarray(jstate["Lt_count"]))
        hist = tstate["Lt_history"].numpy()
        # the candidates of each slot, in batch order
        cand = {}
        seen = {}
        for i in np.flatnonzero(w > 0):
            occ = seen.get(t[i], 0)
            seen[t[i]] = occ + 1
            cand.setdefault((t[i], (count_before[t[i]] + occ) % H), []).append(losses[i])
        collided = [s for s, c in cand.items() if len(c) > 1]
        assert len(collided) > 100
        for s, c in cand.items():
            assert hist[s] in c
            assert hist[s] == c[-1]
        np.testing.assert_array_equal(hist, np.asarray(jstate["Lt_history"]))


def test_importance_sampling_probabilities():
    """``sample_timesteps`` on a full history: ``pt`` of given timesteps
    equal to the JAX package's for its own draw; uniform (pt 1) until full."""
    steps, B = 100, 512
    rng = np.random.default_rng(1)
    hist = (rng.random((steps, 10)) * 2).astype(np.float32)
    jstate = {"Lt_history": jnp.asarray(hist), "Lt_count": jnp.full((steps,), 10, jnp.int32)}
    tstate = {"Lt_history": _t(hist), "Lt_count": torch.full((steps,), 10)}
    key = jax.random.PRNGKey(5)
    jt, jpt = jimp.sample_timesteps(key, jstate, B, "importance")
    tt, tpt = timp.sample_timesteps(tstate, B, "importance", t=_t(jt, torch.int64))
    _close(tpt, jpt)
    gen = torch.Generator().manual_seed(0)
    drawn, pt = timp.sample_timesteps(tstate, 20000, "importance", generator=gen)
    probs, ready = timp.timestep_probs(tstate)
    assert bool(ready) and abs(float(probs.sum()) - 1.0) < 1e-5
    freq = torch.bincount(drawn, minlength=steps).float() / 20000
    assert float((freq - probs).abs().max()) < 0.01
    tstate["Lt_count"][3] = 9
    _, pt = timp.sample_timesteps(tstate, B, "importance", t=_t(jt, torch.int64))
    assert torch.equal(pt, torch.ones(B))


def test_scatter_last_keeps_the_last_write():
    target = torch.zeros(6)
    index = torch.tensor([1, 3, 1, 5, 3, 1])
    values = torch.arange(1.0, 7.0)
    out = timp.scatter_last(target, index, values)
    assert out.tolist() == [0.0, 6.0, 0.0, 5.0, 0.0, 4.0]
    occ = timp.occurrence(torch.tensor([4, 2, 4, 4, 2, 7]))
    assert occ.tolist() == [0, 0, 1, 2, 1, 0]


def test_quick_start_diffrec_on_tiny(tmp_path, monkeypatch):
    """``quick_start`` of DiffRec on tiny on the CPU: one epoch, finite
    results for every metric."""
    import logging

    from genmmrec_tpu_torch.quick_start import quick_start

    monkeypatch.chdir(tmp_path)
    root = logging.getLogger()
    handlers = list(root.handlers)
    try:
        _, valid, test = quick_start("DiffRec", "tiny", {"save_recommended_topk": False}, save_model=False,
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
