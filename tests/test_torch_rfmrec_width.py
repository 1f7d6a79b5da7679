"""RFMRec's velocity net at its published width (6 layers of 512, 8 heads)
against the JAX package, on the CPU, on the tiny tier widened to 200 users
x 600 items, with the JAX initial parameters copied in by name (the model
tests of ``test_torch_rf_models.py`` run it at 2 layers of 64)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from genmmrec_tpu_torch.interop import jax_tree_by_name, params_by_jax_name
from test_torch_rf_hosts import (  # noqa: F401 (_one_torch_thread: an autouse fixture)
    ZERO_GRADS, _one_torch_thread, batch, build_pair, check_grad, close, np_tree, t_,
)
from test_torch_rf_models import _mrec_planes


def test_rfmrec_velocity_at_published_width():
    """RFMRec's velocity net as published (6 layers of 512, 8 heads) on a
    batch of 16, in eval mode and in train mode with the JAX dropout
    planes: its values in float32; in train mode its value and its
    gradients through a random cotangent in float64 on both sides
    (``jax.enable_x64``),
    where the two frameworks' summation orders leave the comparison to the
    arithmetic (in float32 a few elements of the deepest layers' gradients
    stray past 1e-5 of their tensor's largest)."""
    pair = build_pair("RFMRec")
    jm, tm, params = pair["jm"], pair["tm"], pair["params"]
    assert (tm.hidden_dim, tm.n_layers, tm.velocity.cross[0].attn.wq.shape) == (512, 6, (512, 512))
    users, pos, _, _ = batch(jm.n_users, jm.n_items, B=16, seed=3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((16, 2 * jm.embedding_dim)).astype(np.float32)
    t = rng.random((16, 1)).astype(np.float32)
    g_bar = rng.standard_normal((16, 2 * jm.embedding_dim))
    k_drop = jax.random.PRNGKey(5)

    def jax_v(p, key, dtype):
        conds = jm._conditions(p, jnp.asarray(users), jnp.asarray(pos))
        return jm.velocity(p["velocity"], jnp.asarray(x, dtype), jnp.asarray(t, dtype), conds, key)

    def port_v(key):
        keep = None if key is None else _mrec_planes(tm, key, 16)
        dtype = tm.user_embedding.dtype
        return tm.velocity_of(t_(x).to(dtype), t_(t).to(dtype), tm.conditions(t_(users), t_(pos)), keep)

    with torch.no_grad():
        for key in (None, k_drop):
            close(port_v(key), jax.jit(lambda p: jax_v(p, key, jnp.float32))(params))
    tm.double()
    tm.v_feat, tm.t_feat = tm.v_feat.double(), tm.t_feat.double()
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        for key in (k_drop,):
            ref, ref_g = jax.jit(jax.value_and_grad(lambda p: (jax_v(p, key, jnp.float64) * g_bar).sum()))(p64)
            tm.zero_grad(set_to_none=True)
            got = (port_v(key) * t_(g_bar)).sum()
            np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
            got.backward()
            ref_named = jax_tree_by_name(np_tree(ref_g))
            grads = dict(zip(params_by_jax_name(tm), (p.grad for p in tm.parameters())))
            assert grads.keys() == ref_named.keys()
            for k, r in ref_named.items():
                if grads[k] is None:
                    assert not r.any(), k
                else:
                    check_grad(k, grads[k], ref_named, ZERO_GRADS["RFMRec"])
