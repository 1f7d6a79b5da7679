"""One RFGUME and one RFBM3 epoch on tiny against the JAX trainer, on the
CPU, plain and under ``mg``: the same parameters, the JAX plan (slots,
negatives and every draw of each batch's loss: the host's own and the RF
draws, rebuilt from the JAX keys), the JAX trainer's optimizer (the main
chain and the ``"rf"`` AdamW of its ``multi_transform``) stepping the JAX
batches as its ``batch_step`` does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from genmmrec_tpu.config import Config as JConfig
from genmmrec_tpu.data.arrays import build_train_data as j_train
from genmmrec_tpu.data.arrays import sample_negatives as j_sample_negatives
from genmmrec_tpu.data.dataset import RecDataset as JDataset
from genmmrec_tpu.engine.trainer import Trainer as JTrainer
from genmmrec_tpu.models import get_model as j_get_model
from genmmrec_tpu_torch.config import Config as TConfig
from genmmrec_tpu_torch.data.arrays import build_train_data as t_train
from genmmrec_tpu_torch.data.dataset import RecDataset as TDataset
from genmmrec_tpu_torch.engine.trainer import Trainer as TTrainer
from genmmrec_tpu_torch.interop import from_jax_params, jax_tree_by_name, params_by_jax_name
from genmmrec_tpu_torch.models import get_model as t_get_model

CPU = torch.device("cpu")
ONE_DEVICE = {"mesh_shape": {"data": 1, "model": 1}}


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


def _epoch_draws_jax(name, jm, key, B):
    """The JAX arrays behind one batch key's loss draws: the host's own
    (GUME's four noise planes, BM3's four dropout uniforms), then the RF
    draws of its key (``_loss_draws``'s, as uniforms and integers)."""
    if name == "RFGUME":
        k1, k2 = jax.random.split(key)
        shape = (jm.n_users, jm.embedding_dim)
        host = [jax.random.uniform(kk, shape) for k in (k1, k2) for kk in jax.random.split(k)]
        k_rf = jax.random.split(jax.random.fold_in(key, 7))[0]
    else:
        d = jm.embedding_dim
        shapes = [(jm.n_users, d), (jm.n_items, d), (jm.n_items, d), (jm.n_items, d)]
        host = [jax.random.uniform(k, s) for k, s in zip(jax.random.split(key, 4), shapes)]
        k_rf = jax.random.fold_in(key, 1317)
    cfg, n_rows = jm.rf_cfg, jm.n_users + jm.n_items
    k_noise, k_t, k_drop, k_neg = jax.random.split(k_rf, 4)
    n_neg = lambda n: min(cfg.infonce_negative_samples, max(n - 1, 1))
    return dict(
        host=host, x0=jax.random.normal(k_noise, (n_rows, cfg.embedding_dim)), t=jax.random.uniform(k_t, (n_rows, 1)),
        keep=[jax.random.uniform(k, (n_rows, cfg.hidden_dim)) for k in jax.random.split(k_drop, 4 + cfg.n_layers)],
        neg_items=jax.random.randint(k_neg, (B, n_neg(cfg.n_items)), 0, cfg.n_items),
        neg_users=jax.random.randint(jax.random.fold_in(k_neg, 1), (B, n_neg(cfg.n_users)), 0, cfg.n_users),
    )


def _epoch_draws(name, jm, arrays):
    """The port's loss keyword draws from ``_epoch_draws_jax``'s arrays."""
    a = jax.tree_util.tree_map(np.asarray, arrays)
    below = lambda u, p: _t(u < np.float32(p))
    rf_draws = dict(x0=_t(a["x0"]), t=_t(a["t"]), keep=tuple(below(u, 1.0 - jm.rf_cfg.dropout) for u in a["keep"]),
                    neg_items=_t(a["neg_items"], torch.int64), neg_users=_t(a["neg_users"], torch.int64))
    if name == "RFGUME":
        return {"noise": tuple(_t(u) for u in a["host"]), "rf_draws": rf_draws}
    keep = {m: below(u, 1.0 - jm.dropout) for m, u in zip(("user", "item", "text", "image"), a["host"])}
    return {"keep": keep, "rf_draws": rf_draws}


# GUME's modal separation layer is widened in both packages, as in
# tests/test_torch_mm_graph_models.py: at the JAX initialization its bias
# gradient is a cancellation (1e-11 against 1e-9 for the weight), which
# Adam would turn into a full step of rounding noise
def _widened(name, params):
    if name != "RFGUME":
        return params
    layer = dict(params["separate1"])
    layer["w"] = layer["w"] * 30.0
    layer["b"] = jax.random.normal(jax.random.PRNGKey(9), layer["b"].shape) * 0.5
    return {**params, "separate1": layer}


EPOCH_OVER = {"train_batch_size": 64, "save_recommended_topk": False, "rf_loss_weight": 0.2, "alpha1": 1.0,
              "alpha2": 0.3, "beta": 2, **ONE_DEVICE}


def _jax_side(name, over):
    """A model's JAX side on tiny: its trainer's optimizer (the main chain
    and the ``"rf"`` AdamW under ``multi_transform``), the jitted gradient
    and update, the batch plan and keys of one epoch."""
    jc = JConfig(name, "tiny", dict(over))
    jtd = j_train(JDataset(jc).split()[0])
    jm = j_get_model(name)(jc, jtd)
    params = _widened(name, jm.init_params(jax.random.PRNGKey(0)))
    jtr = JTrainer(jc, jm)
    jtr._state = jm.init_state(jax.random.PRNGKey(1))
    optimizer, _ = jtr._build_train_step(jtd)
    B, nb = jtr.train_batch_size, jtr._num_batches
    k_perm, k_scan = jax.random.split(jax.random.PRNGKey(5))
    return dict(name=name, over=over, jm=jm, jtd=jtd, jtr=jtr, params=params, optimizer=optimizer,
                grad_fn=jax.jit(jax.value_and_grad(jm.loss_and_update, has_aux=True)),
                update=jax.jit(optimizer.update),
                negatives=jax.jit(lambda k, u: j_sample_negatives(k, u, jtd.hist, jtd.item_pool, jtd.n_pool,
                                                                  jtr.neg_rounds)),
                draws=jax.jit(lambda k: _epoch_draws_jax(name, jm, k, B)),
                idxs=jax.random.permutation(k_perm, nb * B).reshape(nb, B), keys=jax.random.split(k_scan, nb))


@pytest.fixture(scope="module", params=["RFGUME", "RFBM3"])
def jax_epoch(request):
    return _jax_side(request.param, EPOCH_OVER)


def _jax_batches(js, mg, n_batches):
    """The JAX trainer's optimizer stepping the first ``n_batches`` batches
    of the plan as its ``batch_step`` does: (parameters after them, the
    per-batch losses, the port's plan of the same batches, the first
    batch's gradients)."""
    name, jm, jtd, jtr = js["name"], js["jm"], js["jtd"], js["jtr"]
    grad_fn, update, idxs, keys, jstate = js["grad_fn"], js["update"], js["idxs"], js["keys"], jtr._state
    n_inter = jtd.n_inter
    alpha1, alpha2, beta = EPOCH_OVER["alpha1"], EPOCH_OVER["alpha2"], EPOCH_OVER["beta"]
    p, o = js["params"], js["optimizer"].init(js["params"])
    plan = {"draws": [], "draws2": [], "neg": []}
    ref_losses, first = [], None
    for b in range(n_batches):
        k_neg, k_loss, k_loss2 = jax.random.split(keys[b], 3)
        raw = idxs[b]
        idx = raw % n_inter
        users = jtd.users[idx]
        if jtr.config["use_neg_sampling"]:
            neg = js["negatives"](k_neg, users)
        else:
            neg = jnp.zeros_like(users)
        batch = {"users": users, "pos": jtd.items[idx], "neg": neg, "weight": (raw < n_inter).astype(jnp.float32)}
        (_, (parts, _)), grads = grad_fn(p, jstate, batch, k_loss)
        first = grads if first is None else first
        if mg and b % beta == 0:
            upd, o = update(jax.tree_util.tree_map(lambda g: alpha1 * g, grads), o, p)
            p = optax.apply_updates(p, upd)
            _, g2 = grad_fn(p, jstate, batch, k_loss2)
            grads = jax.tree_util.tree_map(lambda g: -alpha2 * g, g2)
            plan["draws2"].append(_epoch_draws(name, jm, js["draws"](k_loss2)))
        else:
            plan["draws2"].append({})
        upd, o = update(grads, o, p)
        p = optax.apply_updates(p, upd)
        ref_losses.append([float(v) for v in parts])
        plan["neg"].append(_t(neg, torch.int64))
        plan["draws"].append(_epoch_draws(name, jm, js["draws"](k_loss)))
    plan["idx"] = _t(idxs[:n_batches], torch.int64)
    return p, ref_losses, plan, first


def _port_batches(js, mg, plan):
    """The port's trainer on the plan from the same parameters: (the
    trainer, the per-batch losses)."""
    name = js["name"]
    tc = TConfig(name, "tiny", dict(js["over"]))
    ttd = t_train(TDataset(tc).split()[0], CPU)
    tm = t_get_model(name)(tc, ttd)
    from_jax_params(tm, _np_tree(js["params"]))
    ttr = TTrainer(tc, tm, mg=mg)
    ttr.state = tm.init_state()
    ttr._build_train_step(ttd)
    assert ttr._batch_steps == ["main", "rf"]
    return ttr, ttr._train_epoch(plan=plan)


@pytest.mark.parametrize("mg", [False, True], ids=["plain", "mg"])
def test_rf_epoch_matches_the_jax_trainer(jax_epoch, mg):
    """One epoch on tiny from the same parameters on the JAX plan (the
    slots, the negatives and every draw of each batch's loss, both passes
    of ``mg``: alpha1 1, alpha2 0.3, beta 2): the per-batch losses and
    every parameter after the epoch, the ``rf`` subtree included, against
    the JAX trainer's optimizer stepping the JAX batches as its
    ``batch_step`` does, at the tolerances of the repo's other epoch tests
    (rtol 1e-4, atol 1e-5: Adam normalizes a gradient's rounding into its
    step); the ``rf`` subtree moved."""
    nb, beta = jax_epoch["jtr"]._num_batches, EPOCH_OVER["beta"]
    p, ref_losses, plan, _ = _jax_batches(jax_epoch, mg, nb)
    ttr, got = _port_batches(jax_epoch, mg, plan)
    np.testing.assert_allclose(got.numpy(), ref_losses, rtol=1e-4)
    ref = jax_tree_by_name(_np_tree(p))
    before = jax_tree_by_name(_np_tree(jax_epoch["params"]))
    for k, v in params_by_jax_name(ttr.model).items():
        np.testing.assert_allclose(v, ref[k], rtol=1e-4, atol=1e-5, err_msg=k)
    assert all(np.abs(ref[k] - before[k]).max() > 0 for k in ref if k.startswith("rf/"))
    steps = nb + (-(-nb // beta) if mg else 0)
    assert ttr.optimizers["rf"].count == ttr.optimizers["main"].count == steps


@pytest.mark.parametrize("name", ["RFBM3", "RFGUME"])
def test_one_step_at_the_searched_rf_learning_rate(name):
    """One batch at ``rf_learning_rate`` 1e-3 (the staged search's third
    value; the YAMLs' is 3e-4): the ``"rf"`` AdamW's step against the JAX
    trainer's, every parameter after it (rtol 1e-4, atol 1e-5), the ``rf``
    subtree moved by about the rate. Adam's first step is ``lr · g / (|g| +
    1e-8)``: an entry whose gradient is rounding noise (below 1e-6 of its
    tensor's largest, a cancellation in both packages) takes a step of an
    arbitrary share of the rate, so such an entry is held to have moved by at
    most the rate in both packages."""
    js = _jax_side(name, {**EPOCH_OVER, "rf_learning_rate": 1e-3})
    assert js["jm"].rf_cfg.learning_rate == 1e-3
    p, ref_losses, plan, grads = _jax_batches(js, False, 1)
    ttr, got = _port_batches(js, False, plan)
    assert ttr.model.rf_cfg.learning_rate == float(ttr.config["learning_rate"]) == 1e-3
    assert ttr.optimizers["rf"].count == 1
    np.testing.assert_allclose(got.numpy(), ref_losses, rtol=1e-4)
    ref = jax_tree_by_name(_np_tree(p))
    before = jax_tree_by_name(_np_tree(js["params"]))
    g = jax_tree_by_name(_np_tree(grads))
    lr_step = 1e-3 * (1 + 1e-3)
    for k, v in params_by_jax_name(ttr.model).items():
        noise = np.abs(g[k]) <= 1e-6 * np.abs(g[k]).max()
        np.testing.assert_allclose(v[~noise], ref[k][~noise], rtol=1e-4, atol=1e-5, err_msg=k)
        # both optimizers' rate is 1e-3 here (the YAMLs' learning_rate)
        assert max(np.abs(v - before[k])[noise].max(initial=0), np.abs(ref[k] - before[k])[noise].max(initial=0)) \
            <= lr_step, k
    moved = max(np.abs(ref[k] - before[k]).max() for k in ref if k.startswith("rf/"))
    assert 5e-4 < moved <= lr_step
