"""The port's DiffMM training path against the JAX package, on the CPU.

Both packages run the same weights (JAX parameters copied in by name) on
the same synthetic data. Torch's and JAX's random draws differ, so every
draw the JAX package makes (permutations, negatives, timesteps, noise,
dropout masks) is reproduced here with ``jax.random`` and handed to the
port as tensors. Tolerances: 1e-5 relative where one step of float32
arithmetic is compared; 1e-4 relative for losses and parameters after a
whole epoch of Adam steps, where the two packages' summation orders drift
apart step by step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from genmmrec_tpu.common import losses as jl
from genmmrec_tpu.config import Config as JConfig
from genmmrec_tpu.data.arrays import build_train_data as j_train
from genmmrec_tpu.data.arrays import sample_negatives as j_sample_negatives
from genmmrec_tpu.data.dataset import RecDataset as JDataset
from genmmrec_tpu.engine.diffusion_trainers import DiffMMTrainer as JTrainer
from genmmrec_tpu.engine.trainer import Trainer as JBaseTrainer
from genmmrec_tpu.models.diffmm import DiffMM as JDiffMM
from genmmrec_tpu.models.diffusion import apply_dnn, init_dnn
from genmmrec_tpu.models.diffusion import make_schedule as j_schedule
from genmmrec_tpu.models.diffusion import snr as j_snr
from genmmrec_tpu.utils import misc as jmisc
from genmmrec_tpu_torch.common import losses as tl
from genmmrec_tpu_torch.config import Config as TConfig
from genmmrec_tpu_torch.data.arrays import build_eval_data as t_eval
from genmmrec_tpu_torch.data.arrays import build_train_data as t_train
from genmmrec_tpu_torch.data.arrays import sample_negatives
from genmmrec_tpu_torch.data.dataset import RecDataset as TDataset
from genmmrec_tpu_torch.engine.checkpoint import load_checkpoint
from genmmrec_tpu_torch.engine.diffusion_trainers import DiffMMTrainer as TTrainer
from genmmrec_tpu_torch.engine.evaluator import group_masks
from genmmrec_tpu_torch.engine.trainer import make_optimizer
from genmmrec_tpu_torch.interop import from_jax_params, jax_tree_by_name, params_by_jax_name
from genmmrec_tpu_torch.models.diffmm import DiffMM as TDiffMM
from genmmrec_tpu_torch.models.diffusion.dnn import Denoise
from genmmrec_tpu_torch.models.diffusion.schedule import make_schedule as t_schedule
from genmmrec_tpu_torch.models.diffusion.schedule import snr as t_snr
from genmmrec_tpu_torch.utils import misc as tmisc

CPU = torch.device("cpu")
# tiny with batches of 24: 64 users in 3 user batches (8 padding slots),
# 442 interactions in 19 batches (14 padding slots)
TRAIN = {"train_batch_size": 24, "save_recommended_topk": False, "mesh_shape": {"data": 1, "model": 1}}
SMALL = {"synthetic_n_users": 300, "synthetic_n_items": 1600, "synthetic_n_inters": 6000}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a, dtype=None):
    return torch.from_numpy(np.array(a)).to(dtype) if dtype else torch.from_numpy(np.array(a))


def _assert_params(model, jax_params, rtol, atol, prefix=""):
    ref = {k: v for k, v in jax_tree_by_name(_np_tree(jax_params)).items() if k.startswith(prefix)}
    got = {k: v for k, v in params_by_jax_name(model).items() if k.startswith(prefix)}
    assert got.keys() == ref.keys() and ref
    for name in ref:
        np.testing.assert_allclose(got[name], ref[name], rtol=rtol, atol=atol, err_msg=name)


# ----------------------------------------------------------------------
@pytest.mark.parametrize("overrides", [{}, SMALL], ids=["tiny", "small"])
def test_item_pool_bit_identical(overrides):
    jc, tc = JConfig("DiffMM", "tiny", dict(overrides)), TConfig("DiffMM", "tiny", dict(overrides))
    jt, tt = j_train(JDataset(jc).split()[0]), t_train(TDataset(tc).split()[0], CPU)
    np.testing.assert_array_equal(tt.item_pool.numpy(), np.asarray(jt.item_pool))
    assert tt.n_pool == jt.n_pool and tt.item_pool.shape[0] % 128 == 0


def _hist(hist_rows, n_items):
    hist = np.full((len(hist_rows), max(len(h) for h in hist_rows)), n_items, np.int64)
    for i, h in enumerate(hist_rows):
        hist[i, : len(h)] = sorted(h)
    pool = np.resize(np.arange(n_items), -(-n_items // 128) * 128)
    return torch.from_numpy(hist), torch.from_numpy(pool), n_items


def test_sample_negatives_dense_user_takes_the_exact_fallback():
    """All but two items positive: every draw is one of the two free items,
    and both are reached (the JAX package's dense-user case)."""
    hist, pool, n_pool = _hist([list(range(48))], 50)
    users = torch.zeros(256, dtype=torch.int64)
    got = set()
    for s in range(8):
        neg = sample_negatives(users, hist, pool, n_pool, generator=torch.Generator().manual_seed(s))
        assert set(neg.tolist()) <= {48, 49}
        got |= set(neg.tolist())
    assert got == {48, 49}


def test_sample_negatives_sparse_user_roughly_uniform():
    hist, pool, n_pool = _hist([[0, 1, 2, 3]], 128)
    neg = sample_negatives(torch.zeros(4096, dtype=torch.int64), hist, pool, n_pool, generator=torch.Generator().manual_seed(0))
    assert not set(neg.tolist()) & {0, 1, 2, 3}
    counts = np.bincount(neg.numpy(), minlength=128)[4:]
    assert counts.min() > 0 and counts.max() < counts.mean() * 3


def test_sample_negatives_never_a_positive_on_train_data():
    """Tiny's real histories (users with up to a third of the catalog): no
    negative is a positive, in the port's draws as in the JAX package's."""
    tc, jc = TConfig("DiffMM", "tiny", {}), JConfig("DiffMM", "tiny", {})
    td, jtd = t_train(TDataset(tc).split()[0], CPU), j_train(JDataset(jc).split()[0])
    users = torch.arange(td.n_users).repeat(40)
    pos = {(int(u), int(i)) for u, i in zip(td.users, td.items)}
    neg = sample_negatives(users, td.hist, td.item_pool, td.n_pool, 8, torch.Generator().manual_seed(3))
    jneg = j_sample_negatives(jax.random.PRNGKey(3), jnp.asarray(users.numpy(), jnp.int32), jtd.hist, jtd.item_pool, jtd.n_pool, 8)
    for draws in (neg.tolist(), np.asarray(jneg).tolist()):
        assert not any((int(u), n) in pos for u, n in zip(users, draws))
    assert len(set(neg.tolist())) > 0.8 * td.n_items


# ----------------------------------------------------------------------
def test_losses_match():
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal(64).astype(np.float32), rng.standard_normal(64).astype(np.float32)
    w = (rng.random(64) < 0.8).astype(np.float32)
    for gamma in (1e-10, 0.0):
        for weights in (None, w):
            ref = jl.bpr_loss(jnp.asarray(a), jnp.asarray(b), None if weights is None else jnp.asarray(weights), gamma)
            got = tl.bpr_loss(_t(a), _t(b), None if weights is None else _t(weights), gamma)
            np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    e1, e2 = rng.standard_normal((30, 8)).astype(np.float32), rng.standard_normal((50, 8)).astype(np.float32)
    np.testing.assert_allclose(tl.emb_loss(_t(e1), _t(e2)).item(), float(jl.emb_loss(jnp.asarray(e1), jnp.asarray(e2))), rtol=1e-6)
    np.testing.assert_allclose(tl.l2_loss(_t(e1), _t(e2)).item(), float(jl.l2_loss(jnp.asarray(e1), jnp.asarray(e2))), rtol=1e-6)
    v1, v2 = rng.standard_normal((40, 16)).astype(np.float32), rng.standard_normal((40, 16)).astype(np.float32)
    for weights in (None, w[:40]):
        ref = jl.infonce(jnp.asarray(v1), jnp.asarray(v2), 0.2, None if weights is None else jnp.asarray(weights))
        got = tl.infonce(_t(v1), _t(v2), 0.2, None if weights is None else _t(weights))
        np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)


def test_exp_denominator_streamed_value_and_grad():
    """300 rows in chunks of 64 (a ragged last chunk): value and gradients
    against the JAX package's and against the one-shot form."""
    rng = np.random.default_rng(1)
    p1 = (0.3 * rng.standard_normal((20, 16))).astype(np.float32)
    e2 = (0.3 * rng.standard_normal((300, 16))).astype(np.float32)
    f = lambda p, e: (jl.exp_denominator_streamed(p, e, 0.5, chunk=64) ** 0.5).sum()
    ref, (gp, ge) = jax.value_and_grad(f, argnums=(0, 1))(jnp.asarray(p1), jnp.asarray(e2))
    tp, te = _t(p1).requires_grad_(), _t(e2).requires_grad_()
    out = (tl.exp_denominator_streamed(tp, te, 0.5, chunk=64) ** 0.5).sum()
    out.backward()
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-5)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(gp), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(ge), rtol=1e-4, atol=1e-6)
    one_shot = torch.exp(_t(p1) @ _t(e2).T / 0.5).sum(-1)
    np.testing.assert_allclose(tl.exp_denominator_streamed(_t(p1), _t(e2), 0.5, chunk=64).numpy(), one_shot.numpy(), rtol=1e-6)


def test_snr_and_denoiser_dropout():
    args = ("linear-var", 0.1, 0.0001, 0.02, 5)
    js, ts = j_schedule(*args, beta_fixed_value=1e-4), t_schedule(*args, beta_fixed_value=1e-4)
    t = np.array([-1, 0, 1, 2, 3, 4])
    np.testing.assert_array_equal(t_snr(ts, _t(t)).numpy(), np.asarray(j_snr(js, jnp.asarray(t))))

    in_dims, out_dims, emb = [300, 32], [32, 300], 10
    params = init_dnn(jax.random.PRNGKey(2), in_dims, out_dims, emb)
    net = from_jax_params(Denoise(in_dims, out_dims, emb), _np_tree(params))
    rng = np.random.default_rng(0)
    x = (rng.random((16, 300)) < 0.05).astype(np.float32)
    steps = rng.integers(0, 5, 16)
    k = jax.random.PRNGKey(7)
    keep = np.asarray(jax.random.bernoulli(k, 0.5, x.shape))
    ref = np.asarray(apply_dnn(params, jnp.asarray(x), jnp.asarray(steps), dropout=0.5, key=k))
    with torch.no_grad():
        out = net(_t(x), _t(steps), dropout=0.5, keep=_t(keep)).numpy()
        drawn = net(_t(x), _t(steps), dropout=0.5, generator=torch.Generator().manual_seed(0))
        eval_pass = net(_t(x), _t(steps))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
    assert drawn.shape == eval_pass.shape and not torch.equal(drawn, eval_pass)


# ----------------------------------------------------------------------
def _configs(extra=None):
    over = {**TRAIN, **(extra or {})}
    return JConfig("DiffMM", "tiny", dict(over)), TConfig("DiffMM", "tiny", dict(over))


@pytest.fixture(scope="module")
def pair():
    """The JAX and port DiffMM on tiny with the same parameters, and the
    same regenerated modal graphs (random top-1 items) in both states."""
    jc, tc = _configs()
    j_splits, t_splits = JDataset(jc).split(), TDataset(tc).split()
    jtd, ttd = j_train(j_splits[0]), t_train(t_splits[0], CPU)
    jm, tm = JDiffMM(jc, jtd), TDiffMM(tc, ttd)
    params = jm.init_params(jax.random.PRNGKey(0))
    from_jax_params(tm, _np_tree(params))
    rng = np.random.default_rng(6)
    tops = {m: rng.integers(0, jtd.n_items, (jtd.n_users, 1)) for m in ("image_ui", "text_ui")}
    jstate = {m: jm.rebuild_ui_graph(jnp.asarray(t, jnp.int32), None) for m, t in tops.items()}
    tstate = {m: tm.rebuild_ui_graph(_t(t)) for m, t in tops.items()}
    return dict(jc=jc, tc=tc, jtd=jtd, ttd=ttd, jm=jm, tm=tm, params=params, jstate=jstate, tstate=tstate,
                t_splits=t_splits)


@pytest.fixture
def fresh(pair):
    """The pair with the port's parameters reset to the JAX init."""
    from_jax_params(pair["tm"], _np_tree(pair["params"]))
    pair["tm"].cl_method = pair["jm"].cl_method = 0
    yield pair
    pair["tm"].cl_method = pair["jm"].cl_method = 0


def test_forward_joint_matches(fresh):
    jm, tm = fresh["jm"], fresh["tm"]
    ref = jm._forward_joint(fresh["params"], fresh["jstate"])
    with torch.no_grad():
        got = tm._forward_joint(fresh["tstate"])
    assert len(got) == len(ref) == 6
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)


def _batch(n_users, n_items, B=24, seed=0):
    rng = np.random.default_rng(seed)
    users, pos, neg = rng.integers(0, n_users, B), rng.integers(0, n_items, B), rng.integers(0, n_items, B)
    w = np.ones(B, np.float32)
    w[-5:] = 0.0
    return users, pos, neg, w


@pytest.mark.parametrize("cl_method", [0, 1])
def test_loss_and_rec_grads_match(fresh, cl_method):
    jm, tm, params = fresh["jm"], fresh["tm"], fresh["params"]
    jm.cl_method = tm.cl_method = cl_method
    users, pos, neg, w = _batch(jm.n_users, jm.n_items)
    jb = {"users": jnp.asarray(users, jnp.int32), "pos": jnp.asarray(pos, jnp.int32),
          "neg": jnp.asarray(neg, jnp.int32), "weight": jnp.asarray(w)}
    (ref, _), grads = jax.value_and_grad(jm.loss, has_aux=True)(params, fresh["jstate"], jb, None)
    tb = {"users": _t(users), "pos": _t(pos), "neg": _t(neg), "weight": _t(w)}
    tm.zero_grad(set_to_none=True)
    total, parts = tm.loss(fresh["tstate"], tb)
    total.backward()
    np.testing.assert_allclose(total.item(), float(ref), rtol=1e-5)
    assert len(parts) == 1 and parts[0] is total
    got = {name: p.grad for name, p in tm.named_parameters()}
    ref_g = jax_tree_by_name(_np_tree(grads))
    port_names = dict(zip(params_by_jax_name(tm), got))
    for jname, pname in port_names.items():
        if jname.startswith("rec/"):
            scale = np.abs(ref_g[jname]).max()
            np.testing.assert_allclose(got[pname].numpy(), ref_g[jname], rtol=1e-4, atol=1e-5 * scale, err_msg=jname)
        else:
            assert got[pname] is None  # the denoisers play no part in the BPR loss


def test_diffusion_losses_and_denoiser_grads_match(fresh):
    jm, tm, params = fresh["jm"], fresh["tm"], fresh["params"]
    users = np.arange(0, jm.n_users, 2)
    x_start = np.asarray(jm.interaction_vectors(jnp.asarray(users, jnp.int32)))
    feats = np.asarray(jm.get_image_feats(params))
    i_emb = np.asarray(params["rec"]["iEmbeds"])
    k = jax.random.PRNGKey(11)
    ts, noise, keep = _jax_diffusion_draws(k, len(users), jm.n_items, jm.steps)

    def jloss(dn):
        d, g = jm.diffusion_losses(dn, jnp.asarray(x_start), jnp.asarray(i_emb), jnp.asarray(feats), k)
        return d.sum() + jm.e_loss * g.sum(), (d, g)

    (_, (jd, jg)), grads = jax.value_and_grad(jloss, has_aux=True)(params["denoise_image"])
    tm.zero_grad(set_to_none=True)
    d, g = tm.diffusion_losses(tm.denoise_image, _t(x_start), _t(i_emb), _t(feats), ts=_t(ts), noise=_t(noise), keep=_t(keep))
    (d.sum() + tm.e_loss * g.sum()).backward()
    np.testing.assert_allclose(d.detach().numpy(), np.asarray(jd), rtol=1e-4)
    np.testing.assert_allclose(g.detach().numpy(), np.asarray(jg), rtol=1e-4)
    ref_g = jax_tree_by_name(_np_tree({"denoise_image": grads}))
    for name, p in tm.denoise_image.named_parameters():
        jname = "denoise_image/" + name.replace("weight", "w").replace("bias", "b").replace(".", "/")
        scale = np.abs(ref_g[jname]).max()
        np.testing.assert_allclose(p.grad.numpy(), ref_g[jname], rtol=1e-4, atol=1e-5 * scale, err_msg=jname)
    assert all(p.grad is None for p in tm.denoise_text.parameters())


def test_param_groups_split_rec_from_the_denoisers(fresh):
    groups = fresh["tm"].param_groups()
    names = {id(p): n for n, p in fresh["tm"].named_parameters()}
    assert {names[id(p)].split(".")[0] for p in groups["rec"]} == {
        "uEmbeds", "iEmbeds", "modal_weight", "image_trans", "text_trans"}
    for m in ("denoise_image", "denoise_text"):
        assert {names[id(p)].split(".")[0] for p in groups[m]} == {m}
    assert sum(len(v) for v in groups.values()) == len(names)


# ----------------------------------------------------------------------
@pytest.mark.parametrize("learner", ["adam", "sgd", "adagrad", "rmsprop"])
@pytest.mark.parametrize("extras", [{}, {"weight_decay": 0.01, "clip_grad_norm": {"max_norm": 0.5}}], ids=["plain", "wd_clip"])
def test_optimizer_steps_match_optax(learner, extras):
    """Four steps over two epochs of two batches, with the schedule
    ``lr · 0.5^(epoch / 1)`` stepping at the epoch boundary."""
    over = {"learner": learner, "learning_rate": 0.05, "learning_rate_scheduler": [0.5, 1], **extras}
    jc, tc = JConfig("DiffMM", "tiny", dict(over)), TConfig("DiffMM", "tiny", dict(over))
    jt = JBaseTrainer(jc, model=None)
    jt._num_batches = 2
    tx = jt._make_optimizer()
    rng = np.random.default_rng(4)
    p0 = {"a": rng.standard_normal((5, 3)).astype(np.float32), "b": rng.standard_normal(7).astype(np.float32)}
    grads = [{k: (3 * rng.standard_normal(v.shape)).astype(np.float32) for k, v in p0.items()} for _ in range(4)]
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    st = tx.init(jp)
    tp = {k: torch.nn.Parameter(_t(v)) for k, v in p0.items()}
    opt = make_optimizer(list(tp.values()), tc, steps_per_epoch=2)
    for g in grads:
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = _t(g[k])
        opt.step()
        for k in p0:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    assert opt.count == 4


def test_optimizer_state_round_trips():
    tc = TConfig("DiffMM", "tiny", {"learning_rate_scheduler": [0.5, 1]})
    p = torch.nn.Parameter(torch.ones(4))
    opt = make_optimizer([p], tc, steps_per_epoch=1)
    p.grad = torch.full((4,), 0.5)
    opt.step()
    q = torch.nn.Parameter(p.detach().clone())
    opt2 = make_optimizer([q], tc, steps_per_epoch=1)
    opt2.load_state_dict(opt.state_dict())
    p.grad, q.grad = torch.full((4,), -1.0), torch.full((4,), -1.0)
    opt.step()
    opt2.step()
    assert opt2.count == 2 and torch.equal(p, q)


# ----------------------------------------------------------------------
def _jax_diffusion_draws(k, B, n_items, steps):
    """The timesteps, noise and keep mask that DiffMM.diffusion_losses draws
    from key ``k``."""
    k_t, k_noise, k_drop = jax.random.split(k, 3)
    return (
        np.asarray(jax.random.randint(k_t, (B,), 0, steps)),
        np.asarray(jax.random.normal(k_noise, (B, n_items))),
        np.asarray(jax.random.bernoulli(k_drop, 0.5, (B, n_items))),
    )


def test_diffusion_epoch_matches_jax(fresh):
    """Phase 1 on tiny from the same parameters and the JAX package's plan:
    per-batch losses, then the denoisers, equal; ``rec`` untouched."""
    jc, tc, jm, tm, params = fresh["jc"], fresh["tc"], fresh["jm"], fresh["tm"], fresh["params"]
    jtr = JTrainer(jc, jm)
    jtr._build_diffusion_phase()
    opt = jtr._diff_opt
    B, U, nb = jtr.train_batch_size, jm.n_users, jtr._n_user_batches
    key = jax.random.PRNGKey(21)
    k_perm, k_scan = jax.random.split(key)
    batches = np.asarray(jax.random.permutation(k_perm, nb * B)).reshape(nb, B)
    keys = jax.random.split(k_scan, nb)
    i_emb = params["rec"]["iEmbeds"]
    feats = {"image": jm.get_image_feats(params), "text": jm.get_text_feats(params)}
    dn = {m: params[f"denoise_{m}"] for m in ("image", "text")}
    ost = {m: opt.init(dn[m]) for m in ("image", "text")}
    plan = {"users": _t(batches)}
    for m in ("image", "text"):
        for k in ("ts", "noise", "keep"):
            plan[f"{k}_{m}"] = []
    ref_losses = []
    for b in range(nb):
        users = jnp.asarray(batches[b], jnp.int32)
        valid = (users < U).astype(jnp.float32)
        x_start = jm.interaction_vectors(jnp.minimum(users, U - 1)) * valid[:, None]
        row = []
        for m, km in zip(("image", "text"), jax.random.split(keys[b])):
            for name, a in zip(("ts", "noise", "keep"), _jax_diffusion_draws(km, B, jm.n_items, jm.steps)):
                plan[f"{name}_{m}"].append(_t(a))

            def modal_loss(p):
                d, g = jm.diffusion_losses(p, x_start, i_emb, feats[m], km)
                return ((d * valid).sum() + jm.e_loss * (g * valid).sum()) / jnp.maximum(valid.sum(), 1.0)

            loss, grads = jax.value_and_grad(modal_loss)(dn[m])
            upd, ost[m] = opt.update(grads, ost[m], dn[m])
            dn[m] = optax.apply_updates(dn[m], upd)
            row.append(float(loss))
        ref_losses.append(row)
    plan = {k: torch.stack(v) if isinstance(v, list) else v for k, v in plan.items()}
    # the loop above is the JAX package's own phase 1
    _, _, _, li, lt = jtr._diffusion_epoch(params, opt.init(params["denoise_image"]), opt.init(params["denoise_text"]), key)
    np.testing.assert_allclose(np.sum(ref_losses, axis=0), [float(li), float(lt)], rtol=1e-5)
    assert (batches >= U).sum() == nb * B - U > 0

    ttr = TTrainer(tc, tm)
    rec_before = {k: v.copy() for k, v in params_by_jax_name(tm).items() if k.startswith("rec/")}
    got = ttr._diffusion_epoch(plan=plan).numpy()
    np.testing.assert_allclose(got, np.asarray(ref_losses), rtol=1e-4)
    after = params_by_jax_name(tm)
    for k, v in rec_before.items():
        np.testing.assert_array_equal(after[k], v, err_msg=k)
    _assert_params(tm, {"denoise_image": dn["image"], "denoise_text": dn["text"]}, 1e-4, 1e-6, prefix="denoise")


def test_bpr_epoch_matches_jax(fresh):
    """One BPR + InfoNCE epoch on tiny from the same parameters, graphs and
    the JAX package's plan (permutation and negatives): per-batch losses and
    the ``rec`` parameters equal; the denoisers untouched."""
    jc, tc, jm, tm, params = fresh["jc"], fresh["tc"], fresh["jm"], fresh["tm"], fresh["params"]
    jtd, jstate = fresh["jtd"], fresh["jstate"]
    jtr = JTrainer(jc, jm)
    jtr._state = jstate
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
        (total, _), grads = grad_fn(p, jstate, batch, k_loss)
        upd, o = optimizer.update(grads, o, p)
        p = optax.apply_updates(p, upd)
        negs.append(np.asarray(neg))
        ref_losses.append(float(total))
    # the loop above is the JAX package's own epoch
    copy = lambda t: jax.tree_util.tree_map(jnp.array, t)
    p_epoch, _, _, totals = train_epoch(copy(params), optimizer.init(copy(params)), jstate, key)
    np.testing.assert_allclose(sum(ref_losses), float(totals[0]), rtol=1e-5)
    assert (np.asarray(idxs) >= n_inter).sum() == nb * B - n_inter > 0

    ttr = TTrainer(tc, tm)
    ttr.state = fresh["tstate"]
    ttr._build_train_step(fresh["ttd"])
    dn_before = {k: v.copy() for k, v in params_by_jax_name(tm).items() if k.startswith("denoise")}
    plan = {"idx": _t(idxs, torch.int64), "neg": _t(np.stack(negs), torch.int64)}
    got = ttr._train_epoch(plan=plan)
    assert got.shape == (nb, 1)
    np.testing.assert_allclose(got[:, 0].numpy(), ref_losses, rtol=1e-4)
    after = params_by_jax_name(tm)
    for k, v in dn_before.items():
        np.testing.assert_array_equal(after[k], v, err_msg=k)
    _assert_params(tm, p, 1e-4, 1e-5, prefix="rec")
    _assert_params(tm, p_epoch, 1e-4, 1e-5, prefix="rec")


# ----------------------------------------------------------------------
def _port_run(tmp_path, extra=None):
    tc = TConfig("DiffMM", "tiny", {"save_recommended_topk": False, "checkpoint_dir": str(tmp_path), **(extra or {})})
    tr, va, te = TDataset(tc).split()
    td = t_train(tr, CPU)
    bs = int(tc["eval_batch_size"])
    tc["pop_mask"], tc["warm_mask"] = group_masks(tr, CPU)
    model = TDiffMM(tc, td)
    return tc, td, t_eval(va, tr, bs, CPU), t_eval(te, tr, bs, CPU), model, TTrainer(tc, model)


def _state_dicts_equal(a, b):
    assert a.keys() == b.keys()
    return all(torch.equal(a[k], b[k]) for k in a)


def test_fit_three_epochs_checkpoint_and_resume(tmp_path):
    tc, td, vd, ted, model, trainer = _port_run(tmp_path)
    best, valid, test = trainer.fit(td, vd, ted, saved=True, verbose=False)
    assert sorted(trainer.train_loss_dict) == [0, 1, 2] and len(trainer.epoch_times) == 3
    assert all(np.isfinite(v) for v in trainer.train_loss_dict.values())
    assert best == valid["recall@20"] > 0 and "Pop_Recall@20" in test
    N = td.n_users + td.n_items
    for m in ("image_ui", "text_ui"):
        g = trainer.state[m]
        assert g.nnz == 2 * td.n_users * model.rebuild_k + N and int(g.cols.max()) < N
    assert (tmp_path / "DiffMM-tiny.pt").is_file()  # saved on the best valid epoch

    # save after epoch 1, resume into a fresh trainer: the same parameters,
    # graphs and optimizer states, and epoch 2 continues as the straight run
    _, _, _, _, m2, t2 = _port_run(tmp_path, {"epochs": 2})
    t2.fit(td, vd, ted, saved=False, verbose=False)
    path = t2._save_checkpoint(1)
    ck = load_checkpoint(path[: -len(".pt")])
    assert ck["epoch"] == 1 and set(ck["optimizers"]) == {"main", "denoise_image", "denoise_text"}
    _, _, _, _, m3, t3 = _port_run(tmp_path, {"epochs": 2, "resume_checkpoint": path[: -len(".pt")]})
    t3.fit(td, vd, ted, saved=False, verbose=False)
    assert t3.start_epoch == 2 and t3.train_loss_dict == {}
    assert _state_dicts_equal(m3.state_dict(), m2.state_dict())
    for m in ("image_ui", "text_ui"):
        assert torch.equal(t3.state[m].vals, t2.state[m].vals) and torch.equal(t3.state[m].cols, t2.state[m].cols)
    _, _, _, _, m4, t4 = _port_run(tmp_path, {"epochs": 3, "resume_checkpoint": path[: -len(".pt")]})
    t4.fit(td, vd, ted, saved=False, verbose=False)
    assert sorted(t4.train_loss_dict) == [2]
    np.testing.assert_allclose(t4.train_loss_dict[2], trainer.train_loss_dict[2], rtol=1e-6)
    assert _state_dicts_equal(m4.state_dict(), model.state_dict())


def test_fit_aborts_on_a_nan_loss(tmp_path):
    tc, td, vd, ted, model, trainer = _port_run(tmp_path)

    def poison(state, generator, epoch):
        with torch.no_grad():
            model.uEmbeds[0, 0] = float("nan")
        return state

    model.pre_epoch = poison
    trainer.fit(td, vd, ted, verbose=False)
    assert trainer.train_loss_dict == {} and trainer.epoch_times == [] and trainer.best_valid_score == -1.0


def test_keep_rate_half_builds_and_trains(tmp_path):
    """With keep_rate 0.5 the trainer builds (its state draws the edge
    dropout from the seed), the self loops are dropped or rescaled by 1/0.5,
    the regenerated graphs stay value-symmetric, and fit runs an epoch."""
    tc, td, vd, ted, model, trainer = _port_run(tmp_path, {"keep_rate": 0.5, "epochs": 1})
    g = trainer.state["image_ui"]
    model.keep_rate = 1.0  # the same graph without the dropout
    ref = model.rebuild_ui_graph(torch.zeros(td.n_users, model.rebuild_k, dtype=torch.int64))
    model.keep_rate = 0.5
    loop = g.rows == g.cols
    assert torch.equal(g.rows, ref.rows) and not g.vals[~loop].any()
    kept = g.vals[loop] != 0
    assert 0 < kept.sum() < loop.sum()
    np.testing.assert_allclose(g.vals[loop][kept].numpy(), (ref.vals[loop][kept] / 0.5).numpy(), rtol=1e-6)
    trainer.fit(td, vd, None, verbose=False)
    assert np.isfinite(trainer.train_loss_dict[0])
    N = td.n_users + td.n_items
    for m in ("image_ui", "text_ui"):
        s = trainer.state[m]
        dense = torch.zeros(N, N).index_put_((s.rows.long(), s.cols.long()), s.vals, accumulate=True)
        assert torch.equal(dense, dense.T) and 0 < int((s.vals == 0).sum()) < s.nnz


def test_early_stopping_and_dict2str_match():
    cases = [(0.5, 0.4, 2, 3, True), (0.3, 0.4, 2, 3, True), (0.3, 0.4, 3, 3, True), (0.3, 0.4, 1, 3, False),
             (0.5, 0.4, 0, 3, False)]
    for c in cases:
        assert tmisc.early_stopping(*c[:4], bigger=c[4]) == jmisc.early_stopping(*c[:4], bigger=c[4])
    d = {"recall@20": 0.123456, "ndcg@20": 1.0}
    assert tmisc.dict2str(d) == jmisc.dict2str(d)


def test_trainer_generators_follow_the_seed(pair):
    """Each use draws from its own stream; the same seed and use give the
    same draws, another use or seed other draws."""
    _, tc = _configs()
    a, b = TTrainer(tc, pair["tm"]), TTrainer(tc, pair["tm"])
    draw = lambda g: torch.rand(8, generator=g)
    assert torch.equal(draw(a.split("epoch", 1, "train")), draw(b.split("epoch", 1, "train")))
    assert not torch.equal(draw(a.split("epoch", 1, "train")), draw(a.split("epoch", 2, "train")))
    _, tc2 = _configs({"seed": [7]})
    c = TTrainer(tc2, pair["tm"])
    assert not torch.equal(draw(a.split("init")), draw(c.split("init")))
    assert a.generator.device == pair["tm"].device
