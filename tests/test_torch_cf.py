"""The port's graph-CF family (BPR, LightGCN, LayerGCN, SELFCFED_LGN)
against the JAX package, on the CPU.

Each model runs on the tiny tier widened to 300 users x 1,600 items (so that
a top-50 list is full), with the JAX initial parameters copied in by name
(``from_jax_params``). Held: the loss (1e-5 relative) and every gradient
against ``jax.grad`` (1e-4 of an element plus 1e-5 of its tensor's largest:
float32 summation order), ``full_embeddings`` (1e-5), the evaluation's
top-50 lists (equal wherever the score gap exceeds 1e-5) and every metric
(1e-4, the rounding of the result dict) against the JAX trainer, and one
LightGCN BPR epoch from the JAX package's plan. Draws that the two packages
cannot share (dropout masks, the pruning's uniforms) are taken from
``jax.random`` and injected.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from genmmrec_tpu.config import Config as JConfig
from genmmrec_tpu.data.arrays import build_eval_data as j_eval
from genmmrec_tpu.data.arrays import build_train_data as j_train
from genmmrec_tpu.data.arrays import sample_negatives as j_sample_negatives
from genmmrec_tpu.data.dataset import RecDataset as JDataset
from genmmrec_tpu.engine.trainer import Trainer as JTrainer
from genmmrec_tpu.models import get_model as j_get_model
from genmmrec_tpu_torch.common.init import init_linear, xavier_normal
from genmmrec_tpu_torch.config import Config as TConfig
from genmmrec_tpu_torch.data.arrays import build_eval_data as t_eval
from genmmrec_tpu_torch.data.arrays import build_train_data as t_train
from genmmrec_tpu_torch.data.dataset import RecDataset as TDataset
from genmmrec_tpu_torch.engine.evaluator import group_masks
from genmmrec_tpu_torch.engine.trainer import Trainer as TTrainer
from genmmrec_tpu_torch.interop import from_jax_params, jax_tree_by_name, params_by_jax_name
from genmmrec_tpu_torch.models import get_model as t_get_model

CPU = torch.device("cpu")
MODELS = ["BPR", "LightGCN", "LayerGCN", "SELFCFED_LGN"]
SLICE = {
    "synthetic_n_users": 300,
    "synthetic_n_items": 1600,
    "synthetic_n_inters": 6000,
    "train_batch_size": 512,
    "dropout": 0.2,
    "save_recommended_topk": False,
    "mesh_shape": {"data": 1, "model": 1},
}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t.to(dtype) if dtype else t


@pytest.fixture(scope="module", params=MODELS)
def pair(request):
    """One model in both packages on the same data, with the same parameters
    and, for LayerGCN, the same pruned graph of an even and an odd epoch."""
    name = request.param
    jc, tc = JConfig(name, "tiny", dict(SLICE)), TConfig(name, "tiny", dict(SLICE))
    j_splits, t_splits = JDataset(jc).split(), TDataset(tc).split()
    jtd, ttd = j_train(j_splits[0]), t_train(t_splits[0], CPU)
    jm, tm = j_get_model(name)(jc, jtd), t_get_model(name)(tc, ttd)
    assert type(tm).__name__ == name
    params = jm.init_params(jax.random.PRNGKey(0))
    from_jax_params(tm, _np_tree(params))
    jstate, tstate = jm.init_state(jax.random.PRNGKey(1)), tm.init_state()
    return dict(name=name, jc=jc, tc=tc, j_splits=j_splits, t_splits=t_splits, jtd=jtd, ttd=ttd, jm=jm, tm=tm,
                params=params, jstate=jstate, tstate=tstate)


def _batch(n_users, n_items, B=96, seed=0):
    rng = np.random.default_rng(seed)
    w = np.ones(B, np.float32)
    w[-7:] = 0.0
    return rng.integers(0, n_users, B), rng.integers(0, n_items, B), rng.integers(0, n_items, B), w


def _states(pair, epoch):
    """The states both models train epoch ``epoch`` with: LayerGCN's pruned
    graph from one injected uniform draw; the others keep theirs."""
    jm, tm = pair["jm"], pair["tm"]
    if pair["name"] != "LayerGCN":
        return pair["jstate"], pair["tstate"]
    key = jax.random.PRNGKey(40 + epoch)
    jstate = jm.pre_epoch(pair["params"], pair["jstate"], key, epoch)
    uniform = np.asarray(jax.random.uniform(key, (jm.n_edges,)))
    tstate = tm.pre_epoch(pair["tstate"], None, epoch, uniform=_t(uniform))
    return jstate, tstate


def test_parameter_names_and_init_state(pair):
    jm, tm = pair["jm"], pair["tm"]
    ref = jax_tree_by_name(_np_tree(pair["params"]))
    got = params_by_jax_name(tm)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert pair["tstate"].keys() == pair["jstate"].keys()
    for k, v in pair["jstate"].items():
        np.testing.assert_allclose(pair["tstate"][k].numpy(), np.asarray(v), rtol=1e-6, atol=1e-7, err_msg=k)
    # the port's own init draws every parameter anew
    before = {k: v.copy() for k, v in got.items()}
    tm.init_params(torch.Generator().manual_seed(3))
    after = params_by_jax_name(tm)
    assert all(not np.array_equal(after[k], before[k]) for k in before)
    from_jax_params(tm, _np_tree(pair["params"]))


@pytest.mark.parametrize("epoch", [0, 1], ids=["even_epoch", "odd_epoch"])
def test_loss_and_grads_match(pair, epoch):
    name, jm, tm, params = pair["name"], pair["jm"], pair["tm"], pair["params"]
    jstate, tstate = _states(pair, epoch)
    if name == "LayerGCN":
        kept = np.asarray(jstate["masked_vals"]) != 0
        assert kept.sum() == 2 * int(jm.n_edges * 0.8)
        np.testing.assert_array_equal(tstate["masked_vals"].numpy() != 0, kept)
        np.testing.assert_allclose(tstate["masked_vals"].numpy(), np.asarray(jstate["masked_vals"]), rtol=1e-6, atol=1e-7)
    users, pos, neg, w = _batch(jm.n_users, jm.n_items, seed=epoch)
    jb = {"users": jnp.asarray(users, jnp.int32), "pos": jnp.asarray(pos, jnp.int32),
          "neg": jnp.asarray(neg, jnp.int32), "weight": jnp.asarray(w)}
    key = jax.random.PRNGKey(7 + epoch)
    (ref, _), grads = jax.value_and_grad(jm.loss, has_aux=True)(params, jstate, jb, key)
    tb = {"users": _t(users), "pos": _t(pos), "neg": _t(neg), "weight": _t(w)}
    extra = {}
    if name == "SELFCFED_LGN":
        k_u, k_i = jax.random.split(key)
        d = jm.latent_size
        extra["keep"] = tuple(
            _t(np.asarray(jax.random.bernoulli(k, 1.0 - jm.dropout, (n, d)))) for k, n in ((k_u, jm.n_users), (k_i, jm.n_items))
        )
    tm.zero_grad(set_to_none=True)
    total, parts = tm.loss(tstate, tb, **extra)
    total.backward()
    np.testing.assert_allclose(total.item(), float(ref), rtol=1e-5)
    assert len(parts) == 1 and parts[0] is total
    ref_g = jax_tree_by_name(_np_tree(grads))
    got = dict(zip(params_by_jax_name(tm), (p.grad for _, p in tm.named_parameters())))
    assert got.keys() == ref_g.keys()
    for k, g in got.items():
        scale = np.abs(ref_g[k]).max()
        np.testing.assert_allclose(g.numpy(), ref_g[k], rtol=1e-4, atol=1e-5 * scale, err_msg=k)
    tm.zero_grad(set_to_none=True)


def test_selfcfed_draws_its_own_dropout():
    tc = TConfig("SELFCFED_LGN", "tiny", {"dropout": 0.5, "save_recommended_topk": False})
    td = t_train(TDataset(tc).split()[0], CPU)
    tm = t_get_model("SELFCFED_LGN")(tc, td)
    tm.init_params(torch.Generator().manual_seed(0))
    x = torch.ones(200, 64)
    dropped = tm._drop(x, torch.Generator().manual_seed(1), None)
    assert set(dropped.unique().tolist()) == {0.0, 2.0} and abs((dropped == 0).float().mean().item() - 0.5) < 0.03
    users, pos, neg, w = _batch(td.n_users, td.n_items, B=32)
    batch = {"users": _t(users), "pos": _t(pos), "neg": _t(neg), "weight": _t(w)}
    a = tm.loss({}, batch, torch.Generator().manual_seed(2))[0]
    b = tm.loss({}, batch, torch.Generator().manual_seed(2))[0]
    c = tm.loss({}, batch, torch.Generator().manual_seed(3))[0]
    assert a.item() == b.item() != c.item()
    assert not bool(tc["use_neg_sampling"]) and not TTrainer(tc, tm).use_neg


def test_full_embeddings_match(pair):
    """``eval_artifacts``: ``full_embeddings`` for three of the models,
    SELFCFED_LGN's online embeddings and their predictions."""
    jm, tm = pair["jm"], pair["tm"]
    ref = jm.eval_artifacts(pair["params"], pair["jstate"])
    with torch.no_grad():
        got = tm.eval_artifacts(pair["tstate"])
    assert len(got) == len(ref) == (4 if pair["name"] == "SELFCFED_LGN" else 2)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)


def _jax_eval_topk(trainer, params, ed):
    if trainer._eval_fn is None:
        trainer._eval_fn = trainer._build_eval_fn()
    n_chunks = ed.users.shape[0] // trainer.eval_batch_size
    dense = trainer._dense_mask(ed, planar=trainer._fused_eval)
    users, mask = trainer._shard_eval_inputs(ed.users, dense)
    return np.asarray(trainer._eval_fn(params, trainer._state, users, mask, n_chunks, dense_mask=True))


@pytest.mark.parametrize("eval_dtype", ["float32", "bfloat16"])
def test_evaluation_matches_the_jax_trainer(pair, eval_dtype, monkeypatch):
    """``evaluate(valid)`` and ``evaluate(test, is_test=True)``: the top-50
    lists equal wherever the two choices' scores are more than a near-tie
    apart, every metric within 1e-4. bfloat16 takes the fused route for the
    models with the base ``scores_cached`` and the plane route for
    SELFCFED_LGN, whose scores stay float32."""
    name, jm, tm, params = pair["name"], pair["jm"], pair["tm"], pair["params"]
    (j_tr, j_va, j_te), (t_tr, t_va, t_te) = pair["j_splits"], pair["t_splits"]
    over = {**SLICE, "eval_dtype": eval_dtype}
    jc, tc = JConfig(name, "tiny", dict(over)), TConfig(name, "tiny", dict(over))
    pop, warm = group_masks(t_tr, CPU)
    jc["pop_mask"], jc["warm_mask"] = jnp.asarray(pop.numpy()), jnp.asarray(warm.numpy())
    tc["pop_mask"], tc["warm_mask"] = pop, warm
    monkeypatch.setattr(jm, "eval_dtype", jnp.dtype(eval_dtype))
    monkeypatch.setattr(tm, "eval_dtype", getattr(torch, eval_dtype))
    jtr, ttr = JTrainer(jc, jm), TTrainer(tc, tm)
    jtr._state, ttr.state = pair["jstate"], pair["tstate"]
    bs = int(jc["eval_batch_size"])
    with torch.no_grad():
        arts = tm.eval_artifacts(ttr.state)
    # a near-tie: 1e-5 in float32, two bfloat16 steps of the largest score in bfloat16
    for j_split, t_split, is_test in ((j_va, t_va, False), (j_te, t_te, True)):
        jed, ted = j_eval(j_split, j_tr, bs), t_eval(t_split, t_tr, bs, CPU)
        j_top, t_top = _jax_eval_topk(jtr, params, jed), ttr.eval_topk(ted).numpy()
        assert t_top.shape == j_top.shape == (ted.users.shape[0], 50) and t_top.min() >= 0
        with torch.no_grad():
            saved, tm.eval_dtype = tm.eval_dtype, torch.float32
            scores = tm.scores_cached(ttr.state, ted.users, arts).numpy()
            tm.eval_dtype = saved
        tie = 1e-5 if eval_dtype == "float32" or name == "SELFCFED_LGN" else np.abs(scores).max() * 2.0**-6
        rows = np.arange(len(scores))[:, None]
        gap = np.abs(scores[rows, t_top] - scores[rows, j_top])
        assert gap[t_top != j_top].max(initial=0.0) <= tie
        if eval_dtype == "float32":
            assert (t_top != j_top).mean() < 0.01
        j_res, t_res = jtr.evaluate(params, jed, is_test=is_test), ttr.evaluate(ted, is_test=is_test)
        assert t_res.keys() == j_res.keys()
        bound = 1e-4 + 1e-9 if eval_dtype == "float32" else 5e-3
        for k in j_res:
            assert abs(t_res[k] - j_res[k]) <= bound, (k, t_res[k], j_res[k])


def test_lightgcn_bpr_epoch_matches_jax():
    """One LightGCN BPR epoch on tiny from the same parameters and the JAX
    package's plan (permutation and negatives): per-batch losses and the
    parameters after the epoch."""
    over = {"train_batch_size": 48, "save_recommended_topk": False, "mesh_shape": {"data": 1, "model": 1}}
    jc, tc = JConfig("LightGCN", "tiny", dict(over)), TConfig("LightGCN", "tiny", dict(over))
    jtd, ttd = j_train(JDataset(jc).split()[0]), t_train(TDataset(tc).split()[0], CPU)
    jm, tm = j_get_model("LightGCN")(jc, jtd), t_get_model("LightGCN")(tc, ttd)
    params = jm.init_params(jax.random.PRNGKey(0))
    from_jax_params(tm, _np_tree(params))
    jtr = JTrainer(jc, jm)
    jtr._state = {}
    optimizer, train_epoch = jtr._build_train_step(jtd)
    B, nb, n_inter = jtr.train_batch_size, jtr._num_batches, jtd.n_inter
    key = jax.random.PRNGKey(5)
    k_perm, k_scan = jax.random.split(key)
    idxs = jax.random.permutation(k_perm, nb * B).reshape(nb, B)
    keys = jax.random.split(k_scan, nb)
    grad_fn = jax.jit(jax.value_and_grad(jm.loss_and_update, has_aux=True))
    p, o = params, optimizer.init(params)
    negs, ref_losses = [], []
    for b in range(nb):
        k_neg, k_loss, _ = jax.random.split(keys[b], 3)
        raw = idxs[b]
        idx = raw % n_inter
        users, pos = jtd.users[idx], jtd.items[idx]
        neg = j_sample_negatives(k_neg, users, jtd.hist, jtd.item_pool, jtd.n_pool, jtr.neg_rounds)
        batch = {"users": users, "pos": pos, "neg": neg, "weight": (raw < n_inter).astype(jnp.float32)}
        (total, _), grads = grad_fn(p, {}, batch, k_loss)
        upd, o = optimizer.update(grads, o, p)
        p = optax.apply_updates(p, upd)
        negs.append(np.asarray(neg))
        ref_losses.append(float(total))
    # the loop above is the JAX package's own epoch
    copy = lambda t: jax.tree_util.tree_map(jnp.array, t)
    p_epoch, _, _, totals = train_epoch(copy(params), optimizer.init(copy(params)), {}, key)
    np.testing.assert_allclose(sum(ref_losses), float(totals[0]), rtol=1e-5)

    ttr = TTrainer(tc, tm)
    ttr._build_train_step(ttd)
    plan = {"idx": _t(idxs, torch.int64), "neg": _t(np.stack(negs), torch.int64)}
    got = ttr._train_epoch(plan=plan)
    assert got.shape == (nb, 1)
    np.testing.assert_allclose(got[:, 0].numpy(), ref_losses, rtol=1e-4)
    for ref in (p, p_epoch):
        ref = jax_tree_by_name(_np_tree(ref))
        for k, v in params_by_jax_name(tm).items():
            np.testing.assert_allclose(v, ref[k], rtol=1e-4, atol=1e-5, err_msg=k)
    # a plan of fewer batches runs just those, drawing its own negatives
    short = ttr._train_epoch(torch.Generator().manual_seed(0), plan={"idx": plan["idx"][:2]})
    assert short.shape == (2, 1) and bool(torch.isfinite(short).all())


@pytest.mark.parametrize("name", MODELS)
def test_fit_two_epochs_on_tiny(name, tmp_path):
    """``get_model`` + ``Trainer.fit`` end to end on tiny: finite losses, a
    valid result for every metric, ``pre_epoch`` state carried (LayerGCN)."""
    tc = TConfig(name, "tiny", {"epochs": 2, "dropout": 0.2, "save_recommended_topk": False, "checkpoint_dir": str(tmp_path)})
    tr, va, te = TDataset(tc).split()
    td = t_train(tr, CPU)
    tc["pop_mask"], tc["warm_mask"] = group_masks(tr, CPU)
    model = t_get_model(name)(tc, td)
    trainer = TTrainer(tc, model)
    score, valid, test = trainer.fit(td, t_eval(va, tr, 64, CPU), t_eval(te, tr, 64, CPU), verbose=False)
    assert len(trainer.train_loss_dict) == 2 and all(np.isfinite(v) for v in trainer.train_loss_dict.values())
    assert 0.0 <= score <= 1.0 and set(valid) == {f"{m}@{k}" for m in ("recall", "ndcg", "precision", "map") for k in (5, 10, 20, 50)}
    assert "Coverage@50" in test
    if name == "LayerGCN":
        full = model._full_vals()
        assert int((trainer.state["masked_vals"] != 0).sum()) == 2 * int(model.n_edges * 0.8) < int((full != 0).sum())


def test_init_helpers_follow_the_jax_rules():
    gen = torch.Generator().manual_seed(0)
    w = xavier_normal((400, 600), gen)
    assert abs(w.std().item() - (2.0 / 1000) ** 0.5) < 2e-3 and abs(w.mean().item()) < 1e-3
    layer = torch.nn.Linear(64, 32)
    init_linear(layer, gen)
    assert abs(layer.weight.std().item() - (2.0 / 96) ** 0.5) < 0.01
    assert layer.bias.abs().max().item() <= 1 / 8 and layer.bias.abs().max().item() > 0
    with pytest.raises(ModuleNotFoundError):
        t_get_model("NoSuchModel")
