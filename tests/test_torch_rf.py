"""The port's Rectified-Flow module (``models/rf_modules.py``), the ``"rf"``
AdamW, the sliced graph products and ``TrainData.times`` against the JAX
package, on the CPU.

Every JAX draw is rebuilt from its key and passed in: the flow's noise,
its times and its dropout planes (``bernoulli(k, p)`` is ``uniform(k) <
p``), the InfoNCE negatives (``randint``, as integers) and the reflow
start. Values are held at rtol 1e-5, atol 1e-5 of the tensor's largest;
gradients at rtol 1e-4, atol 1e-5 of the largest (float32 summation
order). The epochs on the JAX plan are in ``test_torch_rf_train.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from genmmrec_tpu.config import Config as JConfig
from genmmrec_tpu.data.arrays import build_train_data as j_train
from genmmrec_tpu.data.dataset import RecDataset as JDataset
from genmmrec_tpu.models import rf_modules as jrf
from genmmrec_tpu_torch.config import Config as TConfig
from genmmrec_tpu_torch.data.arrays import build_train_data as t_train
from genmmrec_tpu_torch.data.dataset import RecDataset as TDataset
from genmmrec_tpu_torch.engine.trainer import adamw
from genmmrec_tpu_torch.interop import from_jax_params, jax_tree_by_name, params_by_jax_name
from genmmrec_tpu_torch.models import rf_modules as trf
from genmmrec_tpu_torch.ops.graph import interaction_matrix, spmm
from genmmrec_tpu_torch.ops.segment import segment_spmm_plain

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


def _u(key, shape):
    return np.asarray(jax.random.uniform(key, shape))


def _close(got, ref, rtol=1e-5, atol=1e-5, msg=""):
    ref = np.asarray(ref)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol * max(np.abs(ref).max(), 1e-30), err_msg=msg)


def _grads_close(module, jax_grads, prefix=""):
    ref = jax_tree_by_name(_np_tree(jax_grads))
    got = {k: p.grad for k, p in zip(params_by_jax_name(module), module.parameters())}
    assert got.keys() == {k[len(prefix):] for k in ref} if prefix else got.keys() == ref.keys()
    for k, g in got.items():
        r = ref[prefix + k]
        if g is None:
            assert not r.any(), k
            continue
        _close(g, r, rtol=1e-4, atol=1e-5, msg=k)


def _cfgs(**kw):
    base = dict(embedding_dim=8, hidden_dim=16, n_layers=2, dropout=0.1, n_users=10, n_items=14,
                infonce_negative_samples=6, contrast_temp=0.2, contrast_weight=0.7)
    base.update(kw)
    return jrf.RFConfig(**base), trf.RFConfig(**base)


def _velocity_pair(jcfg, tcfg, cond_dim, seed=0):
    params = jrf.init_velocity_net(jax.random.PRNGKey(seed), jcfg, cond_dim)
    net = trf.VelocityNet(tcfg, cond_dim, CPU)
    from_jax_params(net, _np_tree(params))
    return params, net


def _planes(key, cfg, n):
    """The dropout planes of ``apply_velocity``'s ``dropout_key``."""
    return tuple(_t(_u(k, (n, cfg.hidden_dim)) < np.float32(1.0 - cfg.dropout))
                 for k in jax.random.split(key, 4 + cfg.n_layers))


def _loss_draws(key, cfg, n_rows, B, noise=True):
    """``rf_losses``'s draws of ``key`` as the port's dict."""
    k_noise, k_t, k_drop, k_neg = jax.random.split(key, 4)
    n_neg = lambda n: min(cfg.infonce_negative_samples, max(n - 1, 1))
    n_i, n_u = n_neg(cfg.n_items), n_neg(cfg.n_users)
    out = {
        "t": _t(jax.random.uniform(k_t, (n_rows, 1))),
        "keep": _planes(k_drop, cfg, n_rows) if cfg.dropout > 0 else None,
        "neg_items": _t(jax.random.randint(k_neg, (B, n_i), 0, cfg.n_items), torch.int64),
        "neg_users": _t(jax.random.randint(jax.random.fold_in(k_neg, 1), (B, n_u), 0, cfg.n_users), torch.int64),
    }
    if noise:
        out["x0"] = _t(jax.random.normal(k_noise, (n_rows, cfg.embedding_dim)))
    return out


def _staged_draws(key, epoch, cfg, n_rows, B):
    """``rf_losses_staged``'s draws: past the 2-RF switch the reflow start
    ``z0`` and the loss's draws of the second half of the key."""
    if not cfg.reflows(epoch):
        return _loss_draws(key, cfg, n_rows, B)
    k_pair, k_loss = jax.random.split(key)
    z0 = _t(jax.random.normal(jax.random.split(k_pair)[0], (n_rows, cfg.embedding_dim)))
    return {**_loss_draws(k_loss, cfg, n_rows, B, noise=False), "z0": z0}


# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", ["RFGUME", "RFGUMETime", "RFBM3", "GenRecBM3"])
def test_rf_config_from_config(name):
    """Every field from the model's YAML; the grid list ``rf_loss_weight``
    resolves to its first entry, the contrastive weight."""
    jc, tc = JConfig(name, "tiny", dict(ONE_DEVICE)), TConfig(name, "tiny", dict(ONE_DEVICE))
    ref = jrf.RFConfig.from_config(jc, 11, 13, 64)
    got = trf.RFConfig.from_config(tc, 11, 13, 64)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.contrast_weight == 0.2 and got.warmup_epochs == 20
    bare = {"rf_warmup_epochs": 7}
    cfg_j, cfg_t = (c.from_config(type("C", (), {"__getitem__": lambda s, k: bare.get(k)})(), 3, 4, 8)
                    for c in (jrf.RFConfig, trf.RFConfig))
    assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j) and cfg_t.rf_2rf_transition_epoch == 12


def test_time_embedding_and_cosine_gradient():
    """The [sin, cos] embedding over ``half − 1`` frequencies and the closed
    form of ∇cos, a zero row included."""
    t = np.random.default_rng(0).random((33, 1)).astype(np.float32)
    t[0] = 0.0
    t[1] = 1.0
    _close(trf.sinusoidal_time_embedding(_t(t)), jrf.sinusoidal_time_embedding(jnp.asarray(t)))
    _close(trf.sinusoidal_time_embedding(_t(t), 256), jrf.sinusoidal_time_embedding(jnp.asarray(t), 256))
    rng = np.random.default_rng(1)
    a, b = (rng.standard_normal((20, 12)).astype(np.float32) for _ in range(2))
    a[3] = 0.0
    b[5] = 0.0
    ref = jrf.cosine_similarity_gradient(jnp.asarray(a), jnp.asarray(b))
    _close(trf.cosine_similarity_gradient(_t(a), _t(b)), ref)


@pytest.mark.parametrize("mode", ["eval", "train", "train_guided"])
def test_velocity_net_matches(mode):
    """The velocity net in eval mode and in train mode with the JAX
    dropout planes, with and without both guidance terms; its gradients
    through a random cotangent."""
    jcfg, tcfg = _cfgs()
    N, c = 30, 9
    params, net = _velocity_pair(jcfg, tcfg, c)
    rng = np.random.default_rng(2)
    x, cond, prior, x1, g_bar = (rng.standard_normal((N, d)).astype(np.float32) for d in (8, c, 8, 8, 8))
    t = rng.random((N, 1)).astype(np.float32)
    train = mode != "eval"
    key = jax.random.PRNGKey(3) if train else None
    guided = mode == "train_guided"
    kw_j = dict(user_prior=jnp.asarray(prior), x_1=jnp.asarray(x1)) if guided else {}
    kw_t = dict(user_prior=_t(prior), x_1=_t(x1)) if guided else {}

    def jax_v(p):
        return jrf.apply_velocity(p, jcfg, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond), train=train,
                                  dropout_key=key, **kw_j)

    ref = jax.jit(jax_v)(params)
    ref_g = jax.jit(jax.grad(lambda p: (jax_v(p) * g_bar).sum()))(params)
    keep = _planes(key, jcfg, N) if train else None
    got = net(_t(x), _t(t), _t(cond), train=train, keep=keep, **kw_t)
    _close(got, ref)
    (got * _t(g_bar)).sum().backward()
    _grads_close(net, ref_g)
    if train:
        with torch.no_grad():
            assert not torch.allclose(got, net(_t(x), _t(t), _t(cond)))


# the prior-guidance ablation's four settings (scripts/run_ablation_prior.py;
# its port keeps the same table, tests/test_torch_harness.py)
ABLATIONS = {
    "baseline": {"user_guidance_scale": 0.0, "cosine_guidance_scale": 0.0},
    "user_only": {"user_guidance_scale": 0.2, "cosine_guidance_scale": 0.0},
    "cosine_only": {"user_guidance_scale": 0.0, "cosine_guidance_scale": 0.1},
    "both": {"user_guidance_scale": 0.2, "cosine_guidance_scale": 0.1},
}


@pytest.mark.parametrize("ablation", list(ABLATIONS))
def test_velocity_under_the_prior_ablations(ablation):
    """Each ablation's scales reach ``RFConfig`` from RFGUME's config in both
    packages, and the velocity in train mode with both guidance inputs
    given, and its gradients, match the JAX one at those scales; a scale of
    0 drops its term: the velocity equals the one without that input."""
    scales = ABLATIONS[ablation]
    over = {**ONE_DEVICE, **scales}
    ref_cfg = jrf.RFConfig.from_config(JConfig("RFGUME", "tiny", dict(over)), 11, 13, 64)
    got_cfg = trf.RFConfig.from_config(TConfig("RFGUME", "tiny", dict(over)), 11, 13, 64)
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(ref_cfg)
    assert (got_cfg.user_guidance_scale, got_cfg.cosine_guidance_scale) == tuple(scales.values())
    jcfg, tcfg = _cfgs(**scales)
    N, c = 30, 9
    params, net = _velocity_pair(jcfg, tcfg, c, seed=5)
    rng = np.random.default_rng(6)
    x, cond, prior, x1, g_bar = (rng.standard_normal((N, d)).astype(np.float32) for d in (8, c, 8, 8, 8))
    t = rng.random((N, 1)).astype(np.float32)
    key = jax.random.PRNGKey(7)

    def jax_v(p):
        return jrf.apply_velocity(p, jcfg, jnp.asarray(x), jnp.asarray(t), jnp.asarray(cond), train=True,
                                  dropout_key=key, user_prior=jnp.asarray(prior), x_1=jnp.asarray(x1))

    ref = jax.jit(jax_v)(params)
    ref_g = jax.jit(jax.grad(lambda p: (jax_v(p) * g_bar).sum()))(params)
    keep = _planes(key, jcfg, N)
    got = net(_t(x), _t(t), _t(cond), train=True, keep=keep, user_prior=_t(prior), x_1=_t(x1))
    _close(got, ref)
    (got * _t(g_bar)).sum().backward()
    _grads_close(net, ref_g)
    with torch.no_grad():
        kw = {}
        if scales["user_guidance_scale"]:
            kw["user_prior"] = _t(prior)
        if scales["cosine_guidance_scale"]:
            kw["x_1"] = _t(x1)
        assert torch.equal(net(_t(x), _t(t), _t(cond), train=True, keep=keep, **kw), got.detach())


@pytest.mark.parametrize("case", ["noise", "prior_and_fixed_noise"])
def test_rf_losses_and_grads_match(case):
    """``rf_losses`` (flow, InfoNCE, total) and every gradient of the
    velocity net, with ``X0``, ``t``, the planes and the negatives taken
    from the JAX key's own draws."""
    jcfg, tcfg = _cfgs()
    N, B, c = jcfg.n_users + jcfg.n_items, 7, 5
    params, net = _velocity_pair(jcfg, tcfg, c, seed=4)
    rng = np.random.default_rng(5)
    target = rng.standard_normal((N, 8)).astype(np.float32)
    cond = rng.standard_normal((N, c)).astype(np.float32)
    users, pos = rng.integers(0, jcfg.n_users, B), rng.integers(0, jcfg.n_items, B)
    w = np.ones(B, np.float32)
    w[-2:] = 0.0
    prior = fixed = None
    if case != "noise":
        prior = rng.standard_normal((N, 8)).astype(np.float32)
        fixed = rng.standard_normal((N, 8)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    opt = lambda a, f: None if a is None else f(a)

    def jax_loss(p):
        return jrf.rf_losses(p, jcfg, key, jnp.asarray(target), jnp.asarray(cond), opt(prior, jnp.asarray),
                             jnp.asarray(users), jnp.asarray(pos), jnp.asarray(w), fixed_noise=opt(fixed, jnp.asarray))

    (ref, ref_parts), ref_g = jax.jit(jax.value_and_grad(lambda p: (jax_loss(p)[0], jax_loss(p)[1:]),
                                                         has_aux=True))(params)
    draws = _loss_draws(key, jcfg, N, B)
    total, flow, cl = trf.rf_losses(net, _t(target), _t(cond), opt(prior, _t), _t(users), _t(pos), _t(w), draws,
                                    fixed_noise=opt(fixed, _t))
    np.testing.assert_allclose(total.item(), float(ref), rtol=1e-5)
    np.testing.assert_allclose(flow.item(), float(ref_parts[0]), rtol=1e-5)
    np.testing.assert_allclose(cl.item(), float(ref_parts[1]), rtol=1e-5)
    total.backward()
    _grads_close(net, ref_g)


def test_infonce_sampled_with_collisions():
    """``_infonce_sampled`` on a small catalog where negatives collide with
    their positives (moved to ``(idx + 1) % N``), the weighted mean over
    ``max(Σw, 1)``; the gradient into the generated rows."""
    jcfg, tcfg = _cfgs(n_items=6, infonce_negative_samples=1024)
    rng = np.random.default_rng(7)
    rf_e, tgt = (rng.standard_normal((6, 8)).astype(np.float32) for _ in range(2))
    pos = rng.integers(0, 6, 9)
    w = np.full(9, 0.1, np.float32)
    key = jax.random.PRNGKey(8)
    neg = np.asarray(jax.random.randint(key, (9, 5), 0, 6))
    assert (neg == pos[:, None]).sum() > 3 and tcfg.n_negatives(6) == 5

    def jax_nce(r):
        return jrf._infonce_sampled(r, jnp.asarray(tgt), jnp.asarray(pos), jcfg, key, jnp.asarray(w))

    ref, ref_g = jax.jit(jax.value_and_grad(jax_nce))(jnp.asarray(rf_e))
    r = _t(rf_e).requires_grad_(True)
    got = trf.infonce_sampled(r, _t(tgt), _t(pos), tcfg, _t(neg, torch.int64), _t(w))
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    got.backward()
    _close(r.grad, ref_g, rtol=1e-4)


def test_generate_from_the_same_start_noise():
    """The Euler ODE over 7 steps from the same start noise; ``generate``
    draws its own noise from the generator when none is given."""
    jcfg, tcfg = _cfgs(sampling_steps=7)
    params, net = _velocity_pair(jcfg, tcfg, 4, seed=9)
    rng = np.random.default_rng(10)
    cond = rng.standard_normal((25, 4)).astype(np.float32)
    z0 = rng.standard_normal((25, 8)).astype(np.float32)
    ref = jrf.generate(params, jcfg, jax.random.PRNGKey(0), jnp.asarray(cond), start_noise=jnp.asarray(z0))
    _close(trf.generate(net, _t(cond), start_noise=_t(z0)), ref)
    a, b = (trf.generate(net, _t(cond), generator=torch.Generator().manual_seed(1)) for _ in range(2))
    assert torch.equal(a, b) and a.shape == (25, 8)


@pytest.mark.parametrize("epoch", [2, 3])
def test_staged_loss_and_generation_on_both_sides_of_the_switch(epoch):
    """``use_2rf`` with the switch at epoch 3: before it the plain loss and
    ten Euler steps; from it the loss on the reflow pair (z0, generate(z0))
    and one step, against ``rf_losses_staged`` / ``generate_staged``."""
    jcfg, tcfg = _cfgs(use_2rf=True, rf_2rf_transition_epoch=3, sampling_steps=4)
    N, B, c = jcfg.n_users + jcfg.n_items, 5, 4
    params, net = _velocity_pair(jcfg, tcfg, c, seed=11)
    rng = np.random.default_rng(12)
    target = rng.standard_normal((N, 8)).astype(np.float32)
    cond = rng.standard_normal((N, c)).astype(np.float32)
    users, pos, w = rng.integers(0, 10, B), rng.integers(0, 14, B), np.ones(B, np.float32)
    key = jax.random.PRNGKey(13)

    def jax_loss(p):
        return jrf.rf_losses_staged(p, jcfg, key, epoch, jnp.asarray(target), jnp.asarray(cond), None,
                                    jnp.asarray(users), jnp.asarray(pos), jnp.asarray(w))[0]

    ref, ref_g = jax.jit(jax.value_and_grad(jax_loss))(params)
    draws = _staged_draws(key, epoch, tcfg, N, B)
    assert ("z0" in draws) == (epoch == 3)
    total, _, _ = trf.rf_losses_staged(net, epoch, _t(target), _t(cond), None, _t(users), _t(pos), _t(w), draws)
    np.testing.assert_allclose(total.item(), float(ref), rtol=1e-5)
    total.backward()
    _grads_close(net, ref_g)
    z = rng.standard_normal((N, 8)).astype(np.float32)
    ref_gen, one = jax.jit(lambda p, c, z0: (
        jrf.generate_staged(p, jcfg, jax.random.PRNGKey(0), c, epoch, start_noise=z0),
        jrf.generate(p, jcfg, None, c, n_steps=1, start_noise=z0),
    ))(params, jnp.asarray(cond), jnp.asarray(z))
    _close(trf.generate_staged(net, _t(cond), epoch, start_noise=_t(z)), ref_gen)
    assert np.array_equal(np.asarray(ref_gen), np.asarray(one)) == (epoch == 3)


def test_mix_embeddings():
    jcfg, tcfg = _cfgs(warmup_epochs=2, inference_mix_ratio=0.3)
    o, g = np.ones((3, 2), np.float32), np.full((3, 2), 2.0, np.float32)
    for training, epoch, gen in ((True, 5, g), (False, 1, g), (False, 2, None), (False, 2, g)):
        ref = jrf.mix_embeddings(jcfg, jnp.asarray(o), None if gen is None else jnp.asarray(gen), training, epoch)
        _close(trf.mix_embeddings(tcfg, _t(o), None if gen is None else _t(gen), training, epoch), ref)


def test_causal_denoise_matches():
    """The causal denoiser on the tiny interactions (duplicates kept): the
    denoised rows, ``ps_loss`` and the gradients of ``alpha``, ``beta`` and
    the embeddings against ``jax.grad`` of ``ps_loss`` (every caller
    detaches the denoised rows); ``denoise_W``'s gradient is zero in JAX and
    absent in the port (the message passing records no graph)."""
    jc = JConfig("BPR", "tiny", dict(ONE_DEVICE))
    td = j_train(JDataset(jc).split()[0])
    U, I, d = td.n_users, td.n_items, 8
    params = jrf.init_causal_denoiser(jax.random.PRNGKey(14), d, 2)
    params = {**params, "alpha": jnp.float32(1.7), "beta": jnp.float32(-0.3)}
    ego = np.random.default_rng(15).standard_normal((U + I, d)).astype(np.float32)

    def jax_fn(p, e):
        return jrf.causal_denoise(p, e, td.users, td.items, jnp.ones_like(td.users, dtype=jnp.float32), U, I)

    (ps, den), (gp, ge) = jax.jit(jax.value_and_grad(lambda p, e: jax_fn(p, e)[::-1], argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(ego))
    cd = trf.CausalDenoiser(np.array(td.users), np.array(td.items), U, I, d, 2, CPU)
    from_jax_params(cd, _np_tree(params))
    e = _t(ego).requires_grad_(True)
    t_den, t_ps = cd(e)
    assert not t_den.requires_grad
    _close(t_den, den)
    np.testing.assert_allclose(t_ps.item(), float(ps), rtol=1e-5)
    t_ps.backward()
    _close(e.grad, ge, rtol=1e-4)
    _close(cd.alpha.grad, gp["alpha"], rtol=1e-4)
    _close(cd.beta.grad, gp["beta"], rtol=1e-4)
    for layer, ref in zip(cd.denoise_W, gp["denoise_W"]):
        assert layer.weight.grad is None and not np.asarray(ref["w"]).any() and not np.asarray(ref["b"]).any()


def test_rf_adamw_matches_optax():
    """The ``"rf"`` group's optimizer against ``optax.adamw(lr)`` over eight
    steps: adam, decoupled decay 1e-4, a constant rate; a parameter
    without a gradient decays as a zero-gradient leaf does."""
    rng = np.random.default_rng(17)
    p0 = {"a": rng.standard_normal((4, 3)).astype(np.float32), "b": rng.standard_normal(5).astype(np.float32)}
    lr = 3e-3
    tx = optax.adamw(lr)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    st = tx.init(jp)
    tp = {k: torch.nn.Parameter(_t(v)) for k, v in p0.items()}
    opt = adamw(list(tp.values()), lr)
    for s in range(8):
        g = {k: rng.standard_normal(v.shape).astype(np.float32) * (s + 1) for k, v in p0.items()}
        if s == 3:
            g["b"] = np.zeros_like(g["b"])
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = None if (s == 3 and k == "b") else _t(g[k])
        opt.step()
        for k in p0:
            _close(tp[k], jp[k], rtol=1e-6, atol=1e-6, msg=f"{k} step {s}")
    assert opt.count == 8


@pytest.mark.parametrize("d", [1, 6, 516, 4096])
def test_spmm_of_any_width_equals_the_plain_product(d):
    """``spmm`` at widths the kernels do not take (padded to a multiple of
    4, cut into slices of at most 512 columns) bit-equal to the unsliced
    plain product on the tiny R, and its x-gradient the transposed product."""
    jc = JConfig("BPR", "tiny", dict(ONE_DEVICE))
    td = j_train(JDataset(jc).split()[0])
    R = interaction_matrix(np.asarray(td.users), np.asarray(td.items), td.n_users, td.n_items, CPU)
    rng = np.random.default_rng(d)
    x = _t(rng.standard_normal((td.n_items, d)).astype(np.float32)).requires_grad_(True)
    got = spmm(R, x)
    ref = segment_spmm_plain(R.row_ptr, R.cols, R.vals, x.detach(), R.n_rows)
    assert got.shape == (td.n_users, d) and torch.equal(got.detach(), ref)
    g_bar = _t(rng.standard_normal((td.n_users, d)).astype(np.float32))
    (got * g_bar).sum().backward()
    Rt = R.transposed()
    assert torch.equal(x.grad, segment_spmm_plain(Rt.row_ptr, Rt.cols, Rt.vals, g_bar, Rt.n_rows))
    dense = torch.zeros(td.n_users, td.n_items).index_put_((R.rows.long(), R.cols.long()), R.vals, accumulate=True)
    torch.testing.assert_close(got.detach(), dense @ x.detach(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("times", ["file_order", "unix"])
def test_train_data_times_match(times):
    """``TrainData.times``: float32, equal to the JAX field, on the
    synthetic fallback's file order and on Unix times (~1.4e9 s, which
    float32 rounds to multiples of 128)."""
    jc, tc = JConfig("RFGUMETime", "tiny", dict(ONE_DEVICE)), TConfig("RFGUMETime", "tiny", dict(ONE_DEVICE))
    jtr, ttr = JDataset(jc).split()[0], TDataset(tc).split()[0]
    if times == "unix":
        stamps = 1.4e9 + np.random.default_rng(18).integers(0, 10**7, len(jtr.table.users)).astype(np.float64)
        jtr.table.times = ttr.table.times = stamps
    jtd, ttd = j_train(jtr), t_train(ttr, CPU)
    assert ttd.times.dtype == torch.float32
    np.testing.assert_array_equal(ttd.times.numpy(), np.asarray(jtd.times))
    if times == "unix":
        assert (ttd.times.numpy().astype(np.float64) % 128 == 0).all()
    jtr.table.times = ttr.table.times = None
    assert j_train(jtr).times is None and t_train(ttr, CPU).times is None
