"""The integrated RF models (RFGUME, RFGUMETime, GenRecBM3, RFMRec) against
the JAX package, on the CPU, on the tiny tier widened to 200 users x 600
items, with the JAX initial parameters copied in by name.

Held: the parameters (the ``rf`` and ``causal_denoiser`` subtrees, RFMRec's
``velocity`` tree) and what each model builds (RFGUMETime's historical
adjacency at ``temporal_ratio`` 0.3, RFMRec's weighted adjacency,
GenRecBM3's R), the conditions and the RF target (rtol 1e-5, atol 1e-5 of
the largest); the loss (1e-5) and every gradient against ``jax.grad``
(rtol 1e-4, atol 1e-5 of the largest) with every JAX draw rebuilt from its
key and injected; ``full_embeddings`` and the scores with ``warmed`` 0 and
1 from the JAX start noise (RFGUMETime starts from its historical
embeddings); RFMRec's ``generate`` (its velocity net at the published
width is in ``test_torch_rfmrec_width.py``). RFGUME's modal
separation layer is widened in both packages (``test_torch_rf_hosts.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genmmrec_tpu.models import rf_modules as jrf
from genmmrec_tpu_torch.interop import from_jax_state
from test_torch_rf_hosts import (  # noqa: F401 (_one_torch_thread: an autouse fixture)
    _one_torch_thread,
    batch, build_pair, check_embeddings_and_scores, check_loss_and_grads, close, host_draws, np_tree, rf_draws, t_, u_,
)

MODELS = ["RFGUME", "RFGUMETime", "GenRecBM3", "RFMRec"]
EPOCH_KEY = {"RFGUME": "epoch", "RFGUMETime": "epoch", "GenRecBM3": "rf_epoch"}


# RFMRec's published velocity net (6 layers of 512) is held in
# ``test_torch_rfmrec_width.py``; the model tests run it at 2 layers of 64,
# where float32 summation order stays within the tolerances
NARROW = {"RFMRec": {"rf_hidden_dim": 64, "rf_n_layers": 2}}


@pytest.fixture(scope="module", params=MODELS)
def pair(request):
    return build_pair(request.param, NARROW.get(request.param))


def _mrec_planes(tm, k_drop, B):
    """RFMRec's dropout planes of ``k_drop``, by the JAX package's fold-ins."""
    f = jax.random.fold_in
    h, H, keep = tm.hidden_dim, 8, np.float32(1.0 - tm.dropout)
    plane = lambda k, *s: t_(u_(k, s) < keep)
    out = {"time": plane(f(k_drop, 0), B, h), "in": plane(f(k_drop, 4), B, h), "out": plane(f(k_drop, 5), B, h)}
    for j, enc in enumerate(("interaction", "visual", "text")):
        base = f(k_drop, 1 + j)
        out[f"enc_{enc}"] = (plane(f(base, 0), B, h), plane(f(base, 1), B, h))
    for i in range(tm.n_layers):
        lk = f(k_drop, 16 + i)
        out[f"cross{i}_attn"] = plane(f(lk, 0), B, H, 1, 3)
        out[f"cross{i}_ffn1"] = plane(f(lk, 1), B, 1, 4 * h)
        out[f"cross{i}_ffn2"] = plane(f(lk, 2), B, 1, h)
        out[f"selfa{i}_attn"] = plane(f(lk, 3), B, H, 1, 1)
        out[f"res{i}_net1"] = plane(f(lk, 4), B, 2 * h)
    return out


def _port_draws(pair):
    name, jm, tm = pair["name"], pair["jm"], pair["tm"]
    N = jm.n_users + jm.n_items
    if name == "RFMRec":
        def draws(key, B):
            k_noise, k_t, k_drop = jax.random.split(key, 3)
            return {"draws": {"x0": t_(jax.random.normal(k_noise, (B, 2 * jm.embedding_dim))),
                              "t": t_(jax.random.uniform(k_t, (B, 1))), "keep": _mrec_planes(tm, k_drop, B)}}
        return draws
    if name == "GenRecBM3":
        return lambda key, B: {**host_draws(name, jm, key, B),
                               "rf_draws": rf_draws(jm.rf_cfg, jax.random.fold_in(key, 1317), N, B)}
    return lambda key, B: {**host_draws(name, jm, key, B),
                           "rf_draws": rf_draws(jm.rf_cfg, jax.random.split(jax.random.fold_in(key, 7))[0], N, B)}


def _ego(params):
    return jnp.concatenate([params["user_embedding"], params["item_id_embedding"]])


def test_built_pieces_match(pair):
    """Parameters by name (every subtree), then what each model builds and
    feeds the flow: RFGUME's explicit embeddings and denoised target,
    RFGUMETime's historical adjacency and source, GenRecBM3's R, conditions
    and denoised target, RFMRec's weighted adjacency and a batch's
    conditions."""
    from genmmrec_tpu_torch.interop import jax_tree_by_name, params_by_jax_name

    name, jm, tm, params = pair["name"], pair["jm"], pair["tm"], pair["params"]
    ref, got = jax_tree_by_name(np_tree(params)), params_by_jax_name(tm)
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    top = {k.split("/")[0] for k in ref}
    with torch.no_grad():
        if name in ("RFGUME", "RFGUMETime"):
            assert {"rf", "causal_denoiser"} <= top
            exp = jm._explicit_embeds(params)
            for g, r in zip(tm.explicit_embeds()[2:], exp):
                close(g, r)
            den, ps = jrf.causal_denoise(params["causal_denoiser"], _ego(params), jm.data.users,
                                         jm.data.items, jnp.ones_like(jm.data.users, dtype=jnp.float32),
                                         jm.n_users, jm.n_items)
            t_den, t_ps = tm.causal_denoiser(tm._ego())
            close(t_den, den)
            np.testing.assert_allclose(t_ps.item(), float(ps), rtol=1e-5)
        if name == "RFGUMETime":
            g, jg = tm.historical_adj, jm.historical_adj
            np.testing.assert_array_equal(g.rows.numpy(), np.asarray(jg.rows))
            np.testing.assert_array_equal(g.cols.numpy(), np.asarray(jg.cols))
            np.testing.assert_allclose(g.vals.numpy(), np.asarray(jg.vals), rtol=1e-6, atol=1e-7)
            assert 0 < g.nnz < tm.norm_adj.nnz
            close(tm._rf_x0(), jm._rf_x0(params))
        if name == "GenRecBM3":
            assert {"rf", "causal_denoiser"} <= top
            np.testing.assert_array_equal(tm._rf_R.rows.numpy(), np.asarray(jm._rf_R.rows))
            np.testing.assert_array_equal(tm._rf_R.cols.numpy(), np.asarray(jm._rf_R.cols))
            close(tm._rf_conditions(), jm._rf_conditions(params))
            close(tm.rf_host_repr(pair["tstate"]), jm.rf_host_repr(params, pair["jstate"]))
        if name == "RFMRec":
            g, jg = tm.norm_adj, jm.norm_adj
            np.testing.assert_array_equal(g.rows.numpy(), np.asarray(jg.rows))
            np.testing.assert_array_equal(g.cols.numpy(), np.asarray(jg.cols))
            np.testing.assert_allclose(g.vals.numpy(), np.asarray(jg.vals), rtol=1e-6, atol=1e-7)
            users, pos, _, _ = batch(jm.n_users, jm.n_items)
            ref_c = jm._conditions(params, jnp.asarray(users), jnp.asarray(pos))
            got_c = tm.conditions(t_(users), t_(pos))
            for k in ("interaction", "visual", "text"):
                close(got_c[k], ref_c[k], msg=k)


def test_loss_and_grads_match(pair):
    """The loss and every gradient (the ``rf`` subtree and the denoiser's
    ``alpha``/``beta`` too; ``denoise_W``'s is zero in JAX, absent in the
    port)."""
    check_loss_and_grads(pair, _port_draws(pair), n_parts=1)


@pytest.mark.parametrize("warmed", [0, 1])
def test_embeddings_and_scores_match(pair, warmed):
    name = pair["name"]
    if name == "RFMRec":
        # the tables are its scoring embeddings at every epoch; its ODE
        jm, tm, params = pair["jm"], pair["tm"], pair["params"]
        users, pos, _, _ = batch(jm.n_users, jm.n_items, B=24, seed=warmed)
        steps = 1 if warmed else 3
        ref = jm.generate(params, jax.random.PRNGKey(warmed), jnp.asarray(users), jnp.asarray(pos), n_steps=steps)
        z0 = t_(jax.random.normal(jax.random.PRNGKey(warmed), (24, 2 * jm.embedding_dim)))
        got = tm.generate(t_(users), t_(pos), n_steps=steps, start_noise=z0)
        for g, r in zip(got, ref):
            close(g, r)
        with torch.no_grad():
            u, i = tm.full_embeddings(pair["tstate"])
        close(u, params["user_embedding"])
        close(i, params["item_embedding"])
        return
    got = check_embeddings_and_scores(pair, warmed, epoch_key=EPOCH_KEY[name])
    if warmed:
        # the generated term reaches the scores once warmed
        cold = check_embeddings_and_scores(pair, 0, epoch_key=EPOCH_KEY[name])
        assert not torch.allclose(got[1], cold[1])


def test_state_carried_by_interop(pair):
    """``from_jax_state`` carries the RF epoch counters as Python ints."""
    name, jm = pair["name"], pair["jm"]
    jstate = jm.init_state(jax.random.PRNGKey(1))
    if name != "RFMRec":
        jstate = {**jstate, EPOCH_KEY[name]: jnp.int32(7)}
    got = from_jax_state(pair["tm"], np_tree(jstate))
    assert got.keys() == pair["tstate"].keys()
    if name != "RFMRec":
        assert got[EPOCH_KEY[name]] == 7 and type(got[EPOCH_KEY[name]]) is int


def test_rfgumetime_at_ratio_zero_is_rfgume():
    """With ``temporal_ratio`` 0 there is no historical graph: RFGUMETime's
    loss and evaluation embeddings before the warm-up end are RFGUME's."""
    a = build_pair("RFGUME")
    b = build_pair("RFGUMETime", {"temporal_ratio": 0.0})
    assert b["tm"].historical_adj is None and b["jm"].historical_adj is None
    b["tm"].load_state_dict(a["tm"].state_dict())
    users, pos, neg, w = batch(a["jm"].n_users, a["jm"].n_items)
    tb = {"users": t_(users), "pos": t_(pos), "neg": t_(neg), "weight": t_(w)}
    key = jax.random.PRNGKey(7)
    draws = _port_draws(a)(key, len(users))
    la = a["tm"].loss(a["tstate"], tb, **draws)[0]
    lb = b["tm"].loss(b["tstate"], tb, **draws)[0]
    assert la.item() == lb.item()
    with torch.no_grad():
        ea, eb = a["tm"].full_embeddings({"epoch": 0}), b["tm"].full_embeddings({"epoch": 0})
    assert all(torch.equal(x, y) for x, y in zip(ea, eb))
