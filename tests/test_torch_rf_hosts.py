"""The 15 RF host variants (``RFHostMixin`` on a base model) against the JAX
package, on the CPU: RFBM3 and the graph-CF, VBPR, FREEDOM and LATTICE
hosts here, the message-passing and multimodal graph hosts in
``test_torch_rf_mp_hosts.py``.

Each host runs on the tiny tier widened to 200 users x 600 items, with the
JAX initial parameters copied in by name. Held, each host a case: the
parameters (the ``rf`` subtree included) and R (``_rf_R``), the
conditions and ``rf_host_repr`` (rtol 1e-5, atol 1e-5 of the largest);
the loss parts (the host's, the flow, the InfoNCE) and the total (1e-5),
every gradient against ``jax.grad`` (rtol 1e-4, atol 1e-5 of the largest;
the ``rf`` subtree included) with every JAX draw rebuilt from its key and
injected (the host's own draws and the RF draws of ``fold_in(key,
1317)``); ``full_embeddings`` and the scores with ``warmed`` 0 (the
generated term computed and multiplied by 0) and 1, from the start noise
of the JAX ``PRNGKey(0)``.

The JAX-side tie rules of the base models' tests hold here too: DualGNN's
and COHESION's user graphs are the JAX package's neighbours; MGCN's and
GUME's modal attention's first layer is widened in both packages; the
projection biases of FREEDOM are zero but for rounding (their loss terms
cancel).
"""

import importlib.util
import os

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
HOSTS = ["RFBM3", "RFBPR_remove", "RFLightGCN_remove", "RFLayerGCN_remove", "RFVBPR", "RFFREEDOM", "RFLATTICE"]
SLICE = {
    "synthetic_n_users": 200,
    "synthetic_n_items": 600,
    "synthetic_n_inters": 3000,
    "train_batch_size": 64,
    "save_recommended_topk": False,
    "rf_loss_weight": 0.2,
    "mesh_shape": {"data": 1, "model": 1},
}
USER_GRAPH_HOSTS = ("RFDualGNN", "RFCOHESION")
# the first layer of the modal attention, widened in both packages (its
# bias gradient is a cancellation at the JAX initialization)
WIDENED = {"RFMGCN": "query1", "RFGUME": "separate1", "RFGUMETime": "separate1"}
# gradients zero but for rounding, and the weight of their layer: both
# packages' values must stay below 1e-5 of that weight's largest gradient.
# FREEDOM's projection biases add the same term to a positive and a
# negative score. RFMRec's attention: a key bias adds one constant to a
# query's logits, which the softmax cancels; over the self-attention's one
# key the probability is 1 whatever the query and key projections.
ZERO_GRADS = {
    "RFFREEDOM": {"image_trs/b": "image_trs/w", "text_trs/b": "text_trs/w"},
    "RFMRec": {
        **{f"velocity/cross/{i}/attn/bk": f"velocity/cross/{i}/attn/wv" for i in range(6)},
        **{f"velocity/selfa/{i}/attn/{w}": f"velocity/selfa/{i}/attn/wv" for i in range(6)
           for w in ("wq", "wk", "bq", "bk")},
    },
}


def check_grad(k, g, ref_g, zero):
    """One gradient against the JAX one: within rtol 1e-4 and 1e-5 of its
    largest, or, for a gradient zero but for rounding, both below 1e-5 of
    its layer's weight's largest."""
    if k in zero:
        bound = 1e-5 * np.abs(ref_g[zero[k]]).max()
        assert max(np.abs(ref_g[k]).max(), g.abs().max().item()) <= bound, k
    else:
        close(g, ref_g[k], rtol=1e-4, atol=1e-5, msg=k)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run small products in many processes at once (``-n 6``):
    one torch thread each, for this module only, keeps their OpenMP pools
    from spinning against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def t_(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t.to(dtype) if dtype else t


def u_(key, shape):
    return np.asarray(jax.random.uniform(key, shape))


def close(got, ref, rtol=1e-5, atol=1e-5, msg=""):
    ref = np.asarray(ref)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol * max(np.abs(ref).max(), 1e-30), err_msg=msg)


def widened(name, params):
    if name not in WIDENED:
        return params
    layer = dict(params[WIDENED[name]])
    layer["w"] = layer["w"] * 30.0
    layer["b"] = jax.random.normal(jax.random.PRNGKey(9), layer["b"].shape) * 0.5
    return {**params, WIDENED[name]: layer}


def user_graph_from(jm):
    """The JAX model's user graph (neighbours and softmax weights, in its order) as the port's graph."""
    nbrs, w = np.asarray(jm.user_nbrs), np.asarray(jm.user_nbr_w)
    rows = np.repeat(np.arange(jm.n_users), nbrs.shape[1])
    return sorted_graph(t_(rows), t_(nbrs.reshape(-1)), t_(w.reshape(-1)), jm.n_users, jm.n_users)


def build_pair(name, overrides=None):
    """One model in both packages on the same data, with the same
    parameters and jitted JAX loss gradient and evaluation."""
    over = {**SLICE, **(overrides or {})}
    jc, tc = JConfig(name, "tiny", dict(over)), TConfig(name, "tiny", dict(over))
    jtd, ttd = j_train(JDataset(jc).split()[0]), t_train(TDataset(tc).split()[0], CPU)
    jm, tm = j_get_model(name)(jc, jtd), t_get_model(name)(tc, ttd)
    assert type(tm).__name__ == type(jm).__name__
    if name in USER_GRAPH_HOSTS:
        tm.user_graph = user_graph_from(jm)
    params = widened(name, jm.init_params(jax.random.PRNGKey(0)))
    from_jax_params(tm, np_tree(params))
    jstate, tstate = jm.init_state(jax.random.PRNGKey(1)), tm.init_state()
    return dict(name=name, jm=jm, tm=tm, params=params, jstate=jstate, tstate=tstate,
                grad_fn=jax.jit(jax.value_and_grad(jm.loss, has_aux=True)),
                embed_fn=jax.jit(jm.full_embeddings), scores_fn=jax.jit(jm.scores))


def lgmrec_draws(jm, key):
    ks = jax.random.split(key, 8)
    shapes = [(jm.n_items, jm.hyper_num), (jm.n_users, jm.hyper_num)] * 2
    return dict(gumbel=tuple(t_(u_(ks[i], s)) for i, s in enumerate(shapes)),
                keep=tuple(t_(u_(ks[4 + i], s) < np.float32(jm.keep_rate)) for i, s in enumerate(shapes)))


def host_draws(name, jm, key, B):
    """The keyword arguments of the base model's ``loss`` that carry the JAX draws of ``key``."""
    if name in ("RFBM3", "GenRecBM3"):
        p, d = 1.0 - jm.dropout, jm.embedding_dim
        shapes = dict(user=(jm.n_users, d), item=(jm.n_items, d), text=(jm.n_items, d), image=(jm.n_items, d))
        keys = dict(zip(shapes, jax.random.split(key, 4)))
        return {"keep": {m: t_(u_(keys[m], s) < np.float32(p)) for m, s in shapes.items()}}
    if name in ("RFGUME", "RFGUMETime"):
        k1, k2 = jax.random.split(key)
        shape = (jm.n_users, jm.embedding_dim)
        return {"noise": tuple(t_(u_(kk, shape)) for k in (k1, k2) for kk in jax.random.split(k))}
    if name == "RFSMORE":
        shape = (jm.n_users + jm.n_items, jm.embedding_dim)
        return {"keep": tuple(t_(u_(k, shape) < np.float32(1.0 - jm.dropout_rate)) for k in jax.random.split(key, 3))}
    if name == "RFLGMRec":
        return {"draws": lgmrec_draws(jm, key)}
    if name == "RFPGL":
        shape = (B, 2 * jm.embedding_dim)
        return {"keep": tuple(t_(u_(k, shape) < np.float32(1.0 - jm.dropout)) for k in jax.random.split(key, 4))}
    return {}


def rf_draws(cfg, key, n_rows, B):
    """``rf_losses``'s draws of ``key`` as the port's dict."""
    k_noise, k_t, k_drop, k_neg = jax.random.split(key, 4)
    n_neg = lambda n: min(cfg.infonce_negative_samples, max(n - 1, 1))
    return {
        "x0": t_(jax.random.normal(k_noise, (n_rows, cfg.embedding_dim))),
        "t": t_(jax.random.uniform(k_t, (n_rows, 1))),
        "keep": tuple(t_(u_(k, (n_rows, cfg.hidden_dim)) < np.float32(1.0 - cfg.dropout))
                      for k in jax.random.split(k_drop, 4 + cfg.n_layers)),
        "neg_items": t_(jax.random.randint(k_neg, (B, n_neg(cfg.n_items)), 0, cfg.n_items), torch.int64),
        "neg_users": t_(jax.random.randint(jax.random.fold_in(k_neg, 1), (B, n_neg(cfg.n_users)), 0, cfg.n_users),
                        torch.int64),
    }


def batch(n_users, n_items, B=96, seed=0):
    rng = np.random.default_rng(seed)
    w = np.ones(B, np.float32)
    w[-7:] = 0.0
    return rng.integers(0, n_users, B), rng.integers(0, n_items, B), rng.integers(0, n_items, B), w


def check_loss_and_grads(pair, port_draws, n_parts, rf=True):
    """The loss and every gradient against ``jax.grad``: ``port_draws(key,
    B)`` gives the port's loss keyword draws of the JAX key. ``n_parts``
    None: as many parts as the JAX loss; ``rf`` False: a model without the
    flow (``use_rf`` false), no ``rf`` subtree."""
    name, jm, tm, params = pair["name"], pair["jm"], pair["tm"], pair["params"]
    users, pos, neg, w = batch(jm.n_users, jm.n_items)
    jb = {"users": jnp.asarray(users, jnp.int32), "pos": jnp.asarray(pos, jnp.int32),
          "neg": jnp.asarray(neg, jnp.int32), "weight": jnp.asarray(w)}
    key = jax.random.PRNGKey(7)
    (ref, ref_parts), grads = pair["grad_fn"](params, pair["jstate"], jb, key)
    tb = {"users": t_(users), "pos": t_(pos), "neg": t_(neg), "weight": t_(w)}
    tm.zero_grad(set_to_none=True)
    total, parts = tm.loss(pair["tstate"], tb, **port_draws(key, len(users)))
    total.backward()
    np.testing.assert_allclose(total.item(), float(ref), rtol=1e-5)
    assert len(parts) == len(ref_parts) == (n_parts or len(ref_parts))
    for g, r in zip(parts, ref_parts):
        np.testing.assert_allclose(g.item(), float(r), rtol=1e-5, atol=1e-7)
    ref_g = jax_tree_by_name(np_tree(grads))
    got = dict(zip(params_by_jax_name(tm), (p.grad for _, p in tm.named_parameters())))
    assert got.keys() == ref_g.keys()
    assert any(k.startswith(("rf/", "velocity/")) for k in got) == rf
    for k, g in got.items():
        if g is None:
            assert not ref_g[k].any(), k
            continue
        check_grad(k, g, ref_g, ZERO_GRADS.get(name, {}))
    assert all(np.abs(ref_g[k]).max() > 0 for k in ref_g if k.startswith(("rf/out_lin2", "velocity/out_lin2")))
    tm.zero_grad(set_to_none=True)


def check_embeddings_and_scores(pair, warmed, epoch_key="rf_epoch", **kw):
    """``full_embeddings`` and the scores of every third user at an epoch
    before the warm-up's end (``warmed`` 0) or at it (1), from the JAX
    start noise."""
    jm, tm, params = pair["jm"], pair["tm"], pair["params"]
    epoch = jm.rf_cfg.warmup_epochs if warmed else 0
    jstate = {**pair["jstate"], epoch_key: jnp.int32(epoch)}
    tstate = {**pair["tstate"], epoch_key: epoch}
    ref = pair["embed_fn"](params, jstate)
    N = jm.n_users + jm.n_items
    noise = t_(jax.random.normal(jax.random.PRNGKey(0), (N, jm.rf_cfg.embedding_dim)))
    with torch.no_grad():
        got = tm.full_embeddings(tstate, start_noise=noise, **kw)
        users = torch.arange(0, jm.n_users, 3)
        scores = tm.scores_cached(tstate, users, got)
    for g, r in zip(got, ref):
        close(g, r)
    ref_scores = np.asarray(pair["scores_fn"](params, jstate, jnp.asarray(users.numpy(), jnp.int32)))
    close(scores, ref_scores)
    return got


# ----------------------------------------------------------------------
@pytest.fixture(scope="module", params=HOSTS)
def pair(request):
    return build_pair(request.param)


def check_host_pieces(pair):
    """Parameters (the ``rf`` subtree too), R, the conditions and
    ``rf_host_repr`` against the JAX model's."""
    jm, tm, params = pair["jm"], pair["tm"], pair["params"]
    ref, got = jax_tree_by_name(np_tree(params)), params_by_jax_name(tm)
    assert got.keys() == ref.keys() and any(k.startswith("rf/") for k in ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    R, jR = tm._rf_R, jm._rf_R
    np.testing.assert_array_equal(R.rows.numpy(), np.asarray(jR.rows))
    np.testing.assert_array_equal(R.cols.numpy(), np.asarray(jR.cols))
    assert (R.vals == 1).all() and R.nnz == jm.data.n_inter and not R.symmetric
    close(tm._rf_conditions(), jm._rf_conditions(params))
    assert tm._rf_conditions().shape[1] == tm.rf.cond_lin.in_features
    with torch.no_grad():
        close(tm.rf_host_repr(pair["tstate"]), jm.rf_host_repr(params, pair["jstate"]))


def test_host_pieces_match(pair):
    check_host_pieces(pair)
    assert (pair["tm"]._rf_cached is not None) == (pair["name"] in ("RFVBPR",) or pair["name"].endswith("_remove"))


def test_host_loss_and_grads_match(pair):
    name, jm = pair["name"], pair["jm"]
    N = jm.n_users + jm.n_items
    draws = lambda key, B: {**host_draws(name, jm, key, B),
                            "rf_draws": rf_draws(jm.rf_cfg, jax.random.fold_in(key, 1317), N, B)}
    check_loss_and_grads(pair, draws, n_parts=3)


@pytest.mark.parametrize("warmed", [0, 1])
def test_host_embeddings_and_scores_match(pair, warmed):
    check_embeddings_and_scores(pair, warmed)


# ----------------------------------------------------------------------
# the branches the experiment harnesses reach (scripts/*_torch.py)
def harness_overrides(name, dataset="baby"):
    """``run_rf_models_torch.py``'s overrides of ``name`` at ``dataset``
    (its table equals the JAX ``run_rf_models.py``'s:
    ``tests/test_torch_harness.py``)."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts",
                        "run_rf_models_torch.py")
    spec = importlib.util.spec_from_file_location("run_rf_models_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return dict(mod.MODEL_DATASET_CONFIGS.get(name, {}).get(dataset, {}))


EPOCH_KEYS = {"RFGUME": "epoch"}


@pytest.fixture(scope="module", params=["RFBM3", "RFGUME", "RFFREEDOM", "RFLGMRec", "RFSMORE"])
def pair_without_rf(request):
    """A host with ``use_rf`` false and the RF comparison's baby overrides
    (``run_rf_models``' ``MODEL_DATASET_CONFIGS``: RFLGMRec's hyper_num 4,
    RFSMORE's image_knn_k 40, ...)."""
    name = request.param
    p = build_pair(name, {**harness_overrides(name), "use_rf": False})
    if name == "RFLGMRec":
        p["tm"].repr_draws = lgmrec_draws(p["jm"], jax.random.PRNGKey(0))
    return p


def test_host_without_rf_matches(pair_without_rf):
    """``use_rf`` false: no flow in either package (no ``rf`` subtree, no
    ``"rf"`` optimizer group), the overrides applied, the host's loss parts
    and every gradient against ``jax.grad`` with the host's own draws, and
    the embeddings and scores past the warm-up equal to the JAX model's
    (no generated term)."""
    pair = pair_without_rf
    name, jm, tm = pair["name"], pair["jm"], pair["tm"]
    assert not tm.use_rf and not jm.use_rf and tm.label_transforms() == {}
    assert not any(k.startswith("rf/") for k in jax_tree_by_name(np_tree(pair["params"])))
    for key, value in harness_overrides(name).items():
        assert tm.config[key] == value == jm.config[key], key
    check_loss_and_grads(pair, lambda key, B: host_draws(name, jm, key, B), n_parts=None, rf=False)
    # LGMRec evaluates with draws (the JAX PRNGKey(0)'s, as its target takes them)
    kw = {"draws": tm.repr_draws} if name == "RFLGMRec" else {}
    check_embeddings_and_scores(pair, 1, epoch_key=EPOCH_KEYS.get(name, "rf_epoch"), **kw)


@pytest.mark.parametrize("name", ["RFBM3", "RFGUME"])
def test_inference_mix_at_the_searched_ratio(name):
    """``rf_inference_mix_ratio`` 0.1 (the staged search's third value; the
    YAMLs' 0.05) past the warm-up: the embeddings and scores with the
    generated term mixed in at that ratio equal the JAX model's, and differ
    from those before the warm-up."""
    pair = build_pair(name, {"rf_inference_mix_ratio": 0.1})
    assert pair["tm"].rf_cfg.inference_mix_ratio == pair["jm"].rf_cfg.inference_mix_ratio == 0.1
    key = EPOCH_KEYS.get(name, "rf_epoch")
    warm = check_embeddings_and_scores(pair, 1, epoch_key=key)
    cold = check_embeddings_and_scores(pair, 0, epoch_key=key)
    assert not torch.allclose(warm[1], cold[1])
