"""The port's flip diffusion and ModalDenoise against the JAX package, on
the CPU.

Every draw of the JAX functions is a uniform plane (``bernoulli(k, p)`` is
``uniform(k, p.shape) < p``), so the tests rebuild JAX's uniforms from its
keys and hand them to the port: the samples must then be equal, entry for
entry. Deterministic outputs are held to float32 rounding: the schedules
to one ulp of 1.0 (``1 − cumprod``, whose products JAX's CPU cumprod takes
in a tree order and the port in sequence), the posterior to 1e-6
relative, the KL, the InfoNCE and the denoiser to 1e-5, whose sums run in
another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genmmrec_tpu.models.diffusion import flip as jflip
from genmmrec_tpu.models.modal_denoise import apply_modal_denoise, init_modal_denoise
from genmmrec_tpu_torch.interop import from_jax_params, jax_tree_by_name, params_by_jax_name
from genmmrec_tpu_torch.models.diffusion import flip as tflip
from genmmrec_tpu_torch.models.modal_denoise import ModalDenoise


def _t(a):
    return torch.from_numpy(np.array(a))


def q_sample_draws(key, shape):
    """(noise, flip uniforms) of ``flip.q_sample`` under ``key``."""
    k_noise, k_flip = jax.random.split(key)
    return _t(jax.random.uniform(k_noise, shape)), _t(jax.random.uniform(k_flip, shape))


def p_sample_draws(key, shape, steps, q_steps):
    """``flip.p_sample``'s draws under ``key``, as the port's ``init`` and
    ``step_u`` arguments."""
    k_init, k_loop = jax.random.split(key)
    init = q_sample_draws(k_init, shape) if q_steps else None
    step_u = [_t(jax.random.uniform(k, shape)) for k in jax.random.split(k_loop, steps)]
    return init, step_u


def _x_start(rows=16, n=120, seed=0, density=0.08):
    x = (np.random.default_rng(seed).random((rows, n)) < density).astype(np.float32)
    x[-3:] = 0.0  # padded rows, as a phase-1 batch has
    return x


@pytest.mark.parametrize("density", [0.0, 0.05, 0.5])
def test_flip_schedules(density):
    x = _x_start(density=density)
    jg, je = jflip.flip_schedules(jnp.asarray(x), 5)
    tg, te = tflip.flip_schedules(_t(x), 5)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0, atol=2.0**-23)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=0, atol=2.0**-23)


@pytest.mark.parametrize("base_temp", [1.0, 4.0])
def test_q_sample_equal_with_jax_uniforms(base_temp):
    x = _x_start(seed=1)
    t = np.random.default_rng(2).integers(0, 5, x.shape[0])
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jflip.q_sample(key, jnp.asarray(x), jnp.asarray(t), 5, base_temp))
    noise, flip_u = q_sample_draws(key, x.shape)
    got = tflip.q_sample(_t(x), _t(t), 5, base_temp, noise=noise, flip_u=flip_u)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref != x).any()


def _denoise_fn(lib):
    """A deterministic stand-in for the denoiser, in either package."""
    w = np.random.default_rng(4).standard_normal((120, 120)).astype(np.float32) * 0.2

    def fn(x, t):
        if lib is jnp:
            return x @ jnp.asarray(w) - 0.3 * t[:, None].astype(jnp.float32)
        return x @ torch.from_numpy(w) - 0.3 * t[:, None].to(torch.float32)

    return fn


@pytest.mark.parametrize("q_steps", [0, 3, 5])
@pytest.mark.parametrize("bayesian", [True, False])
def test_p_sample_equal_with_jax_uniforms(q_steps, bayesian):
    x = _x_start(seed=5)
    key = jax.random.PRNGKey(6 + q_steps)
    j_out, j_probs = jflip.p_sample(key, _denoise_fn(jnp), jnp.asarray(x), 5, q_steps, 1.0, bayesian)
    init, step_u = p_sample_draws(key, x.shape, 5, q_steps)
    t_out, t_probs = tflip.p_sample(_denoise_fn(torch), _t(x), 5, q_steps, 1.0, bayesian, init=init, step_u=step_u)
    np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
    np.testing.assert_allclose(t_probs.numpy(), np.asarray(j_probs), rtol=1e-6, atol=1e-7)
    assert set(np.unique(t_out.numpy()).tolist()) <= {0.0, 1.0}


def test_p_sample_draws_from_a_generator():
    """Without injected uniforms the draws come from the generator: the same
    seed gives the same chain, another seed another one."""
    x = _t(_x_start(seed=7))
    run = lambda seed: tflip.p_sample(
        _denoise_fn(torch), x, 5, 5, generator=torch.Generator().manual_seed(seed)
    )[0]
    assert torch.equal(run(1), run(1)) and not torch.equal(run(1), run(2))


def test_posterior_kl_and_infonce():
    rng = np.random.default_rng(8)
    x = _x_start(seed=8)
    t = rng.integers(0, 5, x.shape[0])
    probs = rng.random(x.shape).astype(np.float32)
    jg, je = jflip.flip_schedules(jnp.asarray(x), 5)
    tg, te = tflip.flip_schedules(_t(x), 5)
    np.testing.assert_allclose(
        tflip.true_posterior(_t(x), _t(t), tg, te).numpy(),
        np.asarray(jflip.true_posterior(jnp.asarray(x), jnp.asarray(t), jg, je)),
        rtol=1e-6, atol=1e-7,
    )
    np.testing.assert_allclose(
        tflip.kl_to_posterior(_t(x), _t(t), _t(probs), 5).numpy(),
        np.asarray(jflip.kl_to_posterior(jnp.asarray(x), jnp.asarray(t), jnp.asarray(probs), 5)),
        rtol=1e-5, atol=1e-7,
    )
    a, b = rng.standard_normal((2, 16, 8)).astype(np.float32)
    a[3] = 0.0  # a zero row normalizes to zero, as in the reference
    np.testing.assert_allclose(
        tflip.infonce_rows(_t(a), _t(b), 0.5).item(),
        float(jflip.infonce_rows(jnp.asarray(a), jnp.asarray(b), 0.5)),
        rtol=1e-5,
    )


def test_kl_carries_no_gradient():
    x = _t(_x_start(seed=9))
    probs = torch.rand(x.shape, requires_grad=True)
    kl = tflip.kl_to_posterior(x, torch.zeros(x.shape[0], dtype=torch.int64), probs, 5)
    assert not kl.requires_grad


@pytest.fixture(scope="module")
def denoiser_pair():
    init = jax.jit(init_modal_denoise, static_argnums=(1, 2, 3), static_argnames=("num_layers", "dim_feedforward"))
    params = init(jax.random.PRNGKey(10), 120, 120, 10, num_layers=2, dim_feedforward=64)
    net = ModalDenoise(120, 120, 10, num_layers=2, dim_feedforward=64)
    from_jax_params(net, jax.tree_util.tree_map(np.asarray, params))
    return params, net


def test_modal_denoise_matches_apply_modal_denoise(denoiser_pair):
    """2 layers, d_ff 64. The cross-attention's constant row is computed once
    in the port and once per row in the JAX package: the same products, so
    the outputs stay within float32 rounding of each other."""
    params, net = denoiser_pair
    x = _x_start(rows=32, seed=11)
    t = np.random.default_rng(12).integers(0, 5, 32)
    ref = np.asarray(apply_modal_denoise(params, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        out = net(_t(x), _t(t)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_modal_denoise_names_and_init(denoiser_pair):
    """Every leaf of the JAX tree has its parameter (norms as ``g`` and
    ``bias``), and ``init_params`` gives the JAX package's constants."""
    params, net = denoiser_pair
    ref = jax_tree_by_name({"denoise_image": jax.tree_util.tree_map(np.asarray, params)})

    class Holder(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.denoise_image = net

    got = params_by_jax_name(Holder())
    assert got.keys() == ref.keys()
    assert "denoise_image/layers/1/ln2/g" in got and "denoise_image/out_ln/b" in got
    fresh = ModalDenoise(120, 120, 10, num_layers=2, dim_feedforward=64)
    fresh.init_params(torch.Generator().manual_seed(0))
    assert torch.all(fresh.layers[0].ca_bv == 0.01) and torch.all(fresh.out2.bias == 0.01)
    assert torch.all(fresh.out_ln.g == 1.0) and torch.all(fresh.layers[1].ln3.bias == 0.0)
    bound = (6.0 / (64 + 64)) ** 0.5
    assert fresh.layers[0].ff1.weight.abs().max() <= bound
