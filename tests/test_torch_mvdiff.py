"""The port's MVDiff and MVDiffTrainer against the JAX package, on the CPU.

MVDiff runs on the tiny tier widened to 200 users x 600 items, with the
JAX initial parameters copied in by name (``from_jax_params``) and the JAX
state carried by ``from_jax_state``; every JAX draw is rebuilt from its key
and injected (``bernoulli(k, p)`` is ``uniform(k) < p``).

Tolerances: forward values within 1e-5 of the tensor's largest entry,
graph values within 1e-6; gradients rtol 1e-4, atol 1e-5 of the tensor's
largest; a linear bias in front of a batch norm has a gradient that is zero
but for rounding, and both packages' stay below 1e-5 of its weight's
largest gradient. Edge lists (filler edges included), top-k indices and
counts must be equal. A phase's loss sums over its batches, each after the
earlier batches' Adam steps, within rtol 1e-4 (Adam turns the rounding of
a zero-but-for-rounding gradient into a step of the learning rate, in
parameters that the batch norms cancel). The sparsity denoisers' reverse
chain of five steps through batch norms grows the float32 rounding of one
step (held at 1e-5) by about 4 a step; the chain is held at 1e-3 of its
largest entry, and phase 4's graphs are held on the JAX package's
denoised rows and item planes. Phase 2's KNN lists may take either of two
near-equal neighbours (each side ranks its own float32 similarity
product): they are held equal but on rows with such a tie, at most 1%.
Each phase starts from the JAX initial parameters and state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genmmrec_tpu.config import Config as JConfig
from genmmrec_tpu.data.arrays import build_train_data as j_train
from genmmrec_tpu.data.dataset import RecDataset as JDataset
from genmmrec_tpu.engine.trainer import get_trainer as j_get_trainer
from genmmrec_tpu.models import get_model as j_get_model
from genmmrec_tpu_torch.config import Config as TConfig
from genmmrec_tpu_torch.data.arrays import build_train_data as t_train
from genmmrec_tpu_torch.data.arrays import interaction_vectors
from genmmrec_tpu_torch.data.dataset import RecDataset as TDataset
from genmmrec_tpu_torch.engine import diffusion_trainers as tdt
from genmmrec_tpu_torch.engine.trainer import get_trainer
from genmmrec_tpu_torch.interop import from_jax_params, from_jax_state, jax_tree_by_name, params_by_jax_name
from genmmrec_tpu_torch.models import get_model as t_get_model
from genmmrec_tpu_torch.ops.graph import SparseGraph

CPU = torch.device("cpu")
SLICE = {
    "synthetic_n_users": 200,
    "synthetic_n_items": 600,
    "synthetic_n_inters": 3000,
    "train_batch_size": 64,
    "save_recommended_topk": False,
    "mesh_shape": {"data": 1, "model": 1},
}
STACKS = ("image_residual", "image_modal", "text_residual", "text_modal")
# a bias in front of a batch norm: its gradient is zero but for rounding
ZERO_GRADS = {f"rec/{s}/{i}/lin/b": f"rec/{s}/{i}/lin/w" for s in STACKS for i in range(3)}
ZERO_GRADS.update({f"rec/{g}/lin/b": f"rec/{g}/lin/w" for g in ("gate_image", "gate_text", "common1")})


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


def _bern(key, p, shape):
    return _t(np.asarray(jax.random.bernoulli(key, p, shape)))


def _close(got, ref, rtol=1e-5, rel_atol=1e-5, msg=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rel_atol * max(np.abs(ref).max(), 1e-30), err_msg=msg)


def _edges_equal(g, jg, msg=""):
    np.testing.assert_array_equal(g.rows.numpy(), np.asarray(jg["rows"]), err_msg=msg)
    np.testing.assert_array_equal(g.cols.numpy(), np.asarray(jg["cols"]), err_msg=msg)
    np.testing.assert_allclose(g.vals.numpy(), np.asarray(jg["vals"]), rtol=1e-6, atol=1e-7, err_msg=msg)


def _init_keep(jm, key):
    """``init_state``'s dropout masks: one key for both graphs."""
    k_ui, k_loop = jax.random.split(key)
    U, N = jm.n_users, jm.n_users + jm.n_items
    m_loop = _bern(k_loop, jm.keep_rate, (N,))
    k_img = jm.rebuild_k + jm.high_order_topk
    return {"image": (_bern(k_ui, jm.keep_rate, (U * k_img,)), m_loop),
            "text": (_bern(k_ui, jm.keep_rate, (U * jm.rebuild_k,)), m_loop)}


@pytest.fixture(scope="module")
def pair():
    over = dict(SLICE)
    jc, tc = JConfig("MVDiff", "tiny", dict(over)), TConfig("MVDiff", "tiny", dict(over))
    jtd, ttd = j_train(JDataset(jc).split()[0]), t_train(TDataset(tc).split()[0], CPU)
    jm, tm = j_get_model("MVDiff")(jc, jtd), t_get_model("MVDiff")(tc, ttd)
    params = jax.jit(jm.init_params)(jax.random.PRNGKey(0))
    from_jax_params(tm, _np_tree(params))
    skey = jax.random.PRNGKey(1)
    jstate = jm.init_state(skey)
    return dict(jm=jm, tm=tm, params=params, jstate=jstate, skey=skey, tstate=from_jax_state(tm, _np_tree(jstate)))


def test_parameters_and_state_match(pair):
    """Parameters by name; ``init_state`` on the JAX masks (the placeholder
    user-item graphs, the KNN graphs beside their empty filler edges, the
    empty fusion graph, the dense planes) and the state carried across."""
    jm, tm, jstate = pair["jm"], pair["tm"], pair["jstate"]
    ref, got = jax_tree_by_name(_np_tree(pair["params"])), params_by_jax_name(tm)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    fresh = tm.init_state(keep=_init_keep(jm, pair["skey"]))
    assert fresh.keys() == jstate.keys() == pair["tstate"].keys()
    for name in ("image_ui", "text_ui", "image_ii", "text_ii", "fusion_ii"):
        _edges_equal(fresh[name], jstate[name], name)
        assert isinstance(pair["tstate"][name], SparseGraph)
        assert pair["tstate"][name].sorted == name.endswith("_ui") and pair["tstate"][name].symmetric == name.endswith("_ui")
    for name in ("image_ii_dense", "text_ii_dense"):
        _close(fresh[name], jstate[name], msg=name)
    n, k = jm.n_items, jm.knn_k
    assert (fresh["image_ii"].rows[n * k:] == 0).all() and (fresh["image_ii"].vals[n * k:] == 0).all()


def _batch(jm, B=96):
    rng = np.random.default_rng(0)
    w = np.ones(B, np.float32)
    w[-7:] = 0.0
    users, pos, neg = rng.integers(0, jm.n_users, B), rng.integers(0, jm.n_items, B), rng.integers(0, jm.n_items, B)
    jb = {"users": jnp.asarray(users, jnp.int32), "pos": jnp.asarray(pos, jnp.int32),
          "neg": jnp.asarray(neg, jnp.int32), "weight": jnp.asarray(w)}
    return jb, {"users": _t(users), "pos": _t(pos), "neg": _t(neg), "weight": _t(w)}


def test_loss_and_grads_match(pair):
    """The loss (BPR, L2, two InfoNCE heads over the dropout-perturbed
    projections, the JAX masks injected) and every gradient against
    ``jax.grad``, on the initial state."""
    jm, tm, params = pair["jm"], pair["tm"], pair["params"]
    from_jax_params(tm, _np_tree(params))
    jb, tb = _batch(jm)
    key = jax.random.PRNGKey(7)
    (ref, _), grads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(params, pair["jstate"], jb, key)
    rec = params["rec"]
    keep = {m: {part: [_bern(jax.random.fold_in(key, i), 0.9, (jm.n_items, layer["lin"]["w"].shape[0]))
                       for i, layer in enumerate(rec[f"{m}_{part}"])] for part in ("residual", "modal")}
            for m in ("image", "text")}
    tm.zero_grad(set_to_none=True)
    total, parts = tm.loss(pair["tstate"], tb, keep=keep)
    total.backward()
    np.testing.assert_allclose(total.item(), float(ref), rtol=1e-5)
    assert len(parts) == 1 and parts[0] is total
    ref_g = jax_tree_by_name(_np_tree(grads))
    got = dict(zip(params_by_jax_name(tm), (p.grad for _, p in tm.named_parameters())))
    assert got.keys() == ref_g.keys()
    for k, g in got.items():
        if not k.startswith("rec/"):
            # the denoisers train in their own phases
            assert g is None and not ref_g[k].any(), k
            continue
        if k in ZERO_GRADS:
            bound = 1e-5 * np.abs(ref_g[ZERO_GRADS[k]]).max()
            assert max(np.abs(ref_g[k]).max(), g.abs().max().item()) <= bound, k
            continue
        np.testing.assert_allclose(g.numpy(), ref_g[k], rtol=1e-4, atol=1e-5 * np.abs(ref_g[k]).max(), err_msg=k)
    tm.zero_grad(set_to_none=True)


def test_embeddings_and_scores_match(pair):
    jm, tm, params = pair["jm"], pair["tm"], pair["params"]
    from_jax_params(tm, _np_tree(params))
    users = jnp.arange(0, jm.n_users, 3, dtype=jnp.int32)
    with torch.no_grad():
        arts = tm.full_embeddings(pair["tstate"])
        scores = tm.scores_cached(pair["tstate"], _t(users, torch.int64), arts)
    for g, r in zip(arts, jax.jit(jm.full_embeddings)(params, pair["jstate"])):
        _close(g, r)
    _close(scores, jax.jit(jm.scores)(params, pair["jstate"], users))


@pytest.fixture(scope="module")
def trainers(pair):
    """Both packages' trainers on the pair, the JAX phases built."""
    jm, tm = pair["jm"], pair["tm"]
    jtr = j_get_trainer("MVDiff")(jm.config, jm)
    ttr = get_trainer("MVDiff")(tm.config, tm)
    assert isinstance(ttr, tdt.MVDiffTrainer)
    jtr._state = pair["jstate"]
    jtr._build_phases()
    ttr._build_phase_optimizers()
    return jtr, ttr


def _plan_slots(key, n, B):
    k_perm, k_scan = jax.random.split(key)
    nb = -(-n // B)
    idx = _t(jax.random.permutation(k_perm, nb * B).reshape(nb, B), torch.int64)
    return idx, jax.random.split(k_scan, nb)


def _feature_plan(jm, key, B):
    idx, keys = _plan_slots(key, jm.n_items, B)
    draws = []
    for kb in keys:
        row = []
        for k, dim in zip(jax.random.split(kb), (jm.v_dim, jm.t_dim)):
            k_t, k_n = jax.random.split(k)
            row.append((_t(jax.random.randint(k_t, (B,), 0, jm.steps), torch.int64),
                        _t(jax.random.normal(k_n, (B, dim)))))
        draws.append(row)
    return {"idx": idx, "draws": draws}


def _sparsity_plan(jm, key, B):
    idx, keys = _plan_slots(key, jm.n_users, B)
    n = jm.n_items
    widths = [max(1, n // 2), max(1, n // 4), max(1, n // 8)]

    def one(k):
        k_t, k_q, k_d = jax.random.split(k, 3)
        return dict(
            ts=_t(jax.random.randint(k_t, (B,), 0, jm.steps), torch.int64),
            noise=_t(jax.random.normal(k_q, (B, n))),
            keep=dict(input=_bern(k_d, 0.9, (B, n)),
                      down=[_bern(jax.random.fold_in(k_d, i), 0.9, (B, w)) for i, w in enumerate(widths)],
                      up=[_bern(jax.random.fold_in(k_d, i), 0.9, (B, w))
                          for i, w in enumerate((widths[1], widths[0], n))]),
        )

    return {"idx": idx, "draws": [[one(k) for k in jax.random.split(kb)] for kb in keys]}


def _prelude_keys():
    """The keys of one JAX prelude's phases 1, 3 and 4."""
    return jax.random.split(jax.random.PRNGKey(3), 3)


def test_feature_phase_losses_match(pair, trainers):
    """Phase 1 on the JAX plan (slots, timesteps, noise): each modality's
    loss summed over the item batches."""
    jtr, ttr = trainers
    params, k1 = pair["params"], _prelude_keys()[0]
    oi, ot = jtr._feat_opt.init(params["feat_denoise_image"]), jtr._feat_opt.init(params["feat_denoise_text"])
    _, _, _, fli, flt = jtr._feat_epoch(params, oi, ot, k1)
    from_jax_params(pair["tm"], _np_tree(params))
    ttr._build_phase_optimizers()
    losses = ttr.feature_epoch(plan=_feature_plan(pair["jm"], k1, ttr.train_batch_size))
    assert losses.shape == (-(-pair["jm"].n_items // ttr.train_batch_size), 2)
    np.testing.assert_allclose(losses.sum(0).numpy(), np.array([float(fli), float(flt)]), rtol=1e-4)


def test_item_graphs_rebuild_matches(pair, trainers):
    """Phase 2: the image, text and fusion item graphs (the denoised
    features' KNN edges beside the original ones') equal edge for edge but
    at near ties (``_knn_edges_equal``), the dense planes within 1e-5."""
    jtr, ttr = trainers
    jm, tm = pair["jm"], pair["tm"]
    ref = jtr._regen_ii(pair["params"])
    from_jax_params(tm, _np_tree(pair["params"]))
    ttr.state = dict(pair["tstate"])
    ttr.regenerate_items()
    feats = {"image": tm.v_feat, "text": tm.t_feat}
    denoised = {m: tm.feat_p_sample(m) + f for m, f in feats.items()}
    halves = {"image_ii": (denoised["image"], feats["image"]), "text_ii": (denoised["text"], feats["text"]),
              "fusion_ii": (denoised["image"], denoised["text"])}
    tied = {name: _knn_edges_equal(ttr.state[name], ref[name], sources, jm.knn_k, name)
            for name, sources in halves.items()}
    for m in ("image", "text"):
        rows = ~tied[f"{m}_ii"]
        _close(ttr.state[f"{m}_ii_dense"][rows], np.asarray(ref[f"{m}_ii_dense"])[rows], msg=m)


def _knn_edges_equal(g, jg, sources, k, msg):
    """Two KNN edge lists one after the other (the first from ``sources[0]``,
    the second from ``sources[1]``): rows equal; each row's columns equal
    but on rows whose own cosine similarities hold a near tie (two of the
    top k + 1 within 1e-6, where each side's float32 product may rank
    either first), at most 1% of the rows; values within 1e-6 on the equal
    rows. Returns the rows of the first list whose columns differ."""
    np.testing.assert_array_equal(g.rows.numpy(), np.asarray(jg["rows"]), err_msg=msg)
    n = sources[0].shape[0]
    first = None
    for h, src in enumerate(sources):
        part = slice(h * n * k, (h + 1) * n * k)
        got, ref = g.cols.numpy()[part].reshape(n, k), np.asarray(jg["cols"])[part].reshape(n, k)
        f = src / torch.sqrt((src * src).sum(-1, keepdim=True) + 1e-12)
        top = torch.topk(f @ f.T, k + 1).values.numpy()
        tied = (np.diff(top, axis=1) > -1e-6).any(1)
        differ = (got != ref).any(1)
        assert not (differ & ~tied).any() and differ.sum() <= 0.01 * n, (msg, np.flatnonzero(differ))
        same = np.repeat(~differ, k)
        np.testing.assert_allclose(g.vals.numpy()[part][same], np.asarray(jg["vals"])[part][same], rtol=1e-6,
                                   atol=1e-7, err_msg=msg)
        first = differ if first is None else first
    return first


def test_sparsity_phase_losses_match(pair, trainers):
    """Phase 3 on the JAX plan (slots, timesteps, noise, the dropout masks
    of the input and every layer): each modality's loss summed over the
    user batches."""
    jtr, ttr = trainers
    params, k2 = pair["params"], _prelude_keys()[1]
    ui_i, ui_t = jtr._ui_opt.init(params["denoise_image"]), jtr._ui_opt.init(params["denoise_text"])
    _, _, _, uli, ult = jtr._ui_epoch(params, ui_i, ui_t, k2)
    from_jax_params(pair["tm"], _np_tree(params))
    ttr._build_phase_optimizers()
    losses = ttr.sparsity_epoch(plan=_sparsity_plan(pair["jm"], k2, ttr.train_batch_size))
    np.testing.assert_allclose(losses.sum(0).numpy(), np.array([float(uli), float(ult)]), rtol=1e-4)


def test_sparsity_reverse_chain_matches(pair):
    """The sparsity denoisers: each reverse step from the same input within
    1e-5, the five-step chain within 1e-3."""
    jm, tm, params = pair["jm"], pair["tm"], pair["params"]
    from_jax_params(tm, _np_tree(params))
    users = torch.arange(64)
    x = interaction_vectors(tm.data, users)
    xj = jnp.asarray(x.numpy())
    for m in ("image", "text"):
        dn, jp = getattr(tm, f"denoise_{m}"), params[f"denoise_{m}"]
        for i in range(jm.steps):
            with torch.no_grad():
                got = tm.modal_denoise_apply(dn, x, torch.full((64,), i))
            _close(got, jm.modal_denoise_apply(jp, xj, jnp.full((64,), i, jnp.int32)), msg=f"{m} t={i}")
        _close(tm.sparsity_p_sample(dn, x), jm.sparsity_p_sample(jp, xj), rel_atol=1e-3, msg=m)


def test_user_graphs_rebuild_matches(pair, trainers, monkeypatch):
    """Phase 4 on the JAX item planes and denoised rows, with the JAX
    dropout masks: both user-item graphs equal edge for edge, the image
    graph's high-order picks (mostly among exact zeros, so ties to the
    lower index decide) and its filler edges included."""
    jm, tm, params = pair["jm"], pair["tm"], pair["params"]
    jtr, ttr = trainers
    k3 = _prelude_keys()[2]
    ref = jtr._regen_ui(params, pair["jstate"], k3)
    from_jax_params(tm, _np_tree(params))
    ttr.state = dict(pair["tstate"])

    def jax_rows(dn, x):
        which = "denoise_image" if dn is tm.denoise_image else "denoise_text"
        return _t(jm.sparsity_p_sample(params[which], jnp.asarray(x.numpy())))

    monkeypatch.setattr(tm, "sparsity_p_sample", jax_rows)
    k_img, k_txt = jax.random.split(k3)
    U, N = jm.n_users, jm.n_users + jm.n_items

    def keep(k, kk):
        a, b = jax.random.split(k)
        return _bern(a, jm.keep_rate, (U * kk,)), _bern(b, jm.keep_rate, (N,))

    plan = {"keep": {"image": keep(k_img, jm.rebuild_k + jm.high_order_topk), "text": keep(k_txt, jm.rebuild_k)}}
    ttr.regenerate_users(plan=plan)
    for name in ("image_ui", "text_ui"):
        _edges_equal(ttr.state[name], ref[name], name)
        assert ttr.state[name].symmetric and ttr.state[name].nnz == len(ref[name]["rows"])
    # the image graph's rows are mostly exact zeros past each user's few neighbours
    dense = ttr.state["image_ii_dense"] * ttr.state["text_ii_dense"]
    assert float((dense == 0).float().mean()) > 0.9


def test_quick_start_mvdiff_on_tiny(tmp_path, monkeypatch):
    """``quick_start`` of MVDiff on tiny on the CPU: its four phases and the
    BPR epoch, finite results for every metric."""
    import logging

    from genmmrec_tpu_torch.quick_start import quick_start

    monkeypatch.chdir(tmp_path)
    root = logging.getLogger()
    handlers = list(root.handlers)
    seen = {}
    prelude = tdt.MVDiffTrainer._epoch_prelude

    def recording(self, generator, epoch_idx):
        prelude(self, generator, epoch_idx)
        seen.update(self.prelude_log)

    monkeypatch.setattr(tdt.MVDiffTrainer, "_epoch_prelude", recording)
    try:
        _, valid, test = quick_start("MVDiff", "tiny", {"save_recommended_topk": False}, save_model=False,
                                     max_epochs=1, device="cpu")
    finally:
        for h in list(root.handlers):
            root.removeHandler(h)
            if h not in handlers:
                h.close()
        for h in handlers:
            root.addHandler(h)
    assert {"feature_s", "regenerate_items_s", "sparsity_s", "regenerate_users_s"} <= seen.keys()
    assert all(np.isfinite(v) for v in seen.values())
    assert 0.0 <= valid["recall@20"] <= 1.0 and "Coverage@50" in test
    assert all(np.isfinite(v) for v in list(valid.values()) + list(test.values()))
