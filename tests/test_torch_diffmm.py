"""The port's diffusion pieces, DiffMM model and serving slice against the
JAX package, on the CPU.

The JAX parameters go into the port through ``from_jax_params``, so both
packages run the same weights on the same synthetic data. The slice test
uses tiny DiffMM widened to 300 users x 1,600 items with ``dims: [64]``, so
that the regeneration top-1 takes the JAX package's two-stage top-k path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genmmrec_tpu.config import Config as JConfig
from genmmrec_tpu.data.arrays import build_eval_data as j_eval
from genmmrec_tpu.data.arrays import build_train_data as j_train
from genmmrec_tpu.data.dataset import RecDataset as JDataset
from genmmrec_tpu.engine.diffusion_trainers import DiffMMTrainer as JTrainer
from genmmrec_tpu.models.diffmm import DiffMM as JDiffMM
from genmmrec_tpu.models.diffusion import apply_dnn, init_dnn, make_schedule as j_schedule
from genmmrec_tpu.models.diffusion import timestep_embedding as j_temb
from genmmrec_tpu.models.diffusion.schedule import betas_from_linear_variance as j_betas
from genmmrec_tpu_torch.config import Config as TConfig
from genmmrec_tpu_torch.data.arrays import build_eval_data as t_eval
from genmmrec_tpu_torch.data.arrays import build_train_data as t_train
from genmmrec_tpu_torch.data.dataset import RecDataset as TDataset
from genmmrec_tpu_torch.engine.diffusion_trainers import DiffMMTrainer as TTrainer
from genmmrec_tpu_torch.engine.evaluator import group_masks
from genmmrec_tpu_torch.interop import from_jax_params
from genmmrec_tpu_torch.models.diffmm import DiffMM as TDiffMM
from genmmrec_tpu_torch.models.diffusion.dnn import Denoise, timestep_embedding
from genmmrec_tpu_torch.models.diffusion.schedule import make_schedule as t_schedule

CPU = torch.device("cpu")
SLICE = {
    "synthetic_n_users": 300,
    "synthetic_n_items": 1600,
    "synthetic_n_inters": 6000,
    "dims": [64],
    "save_recommended_topk": False,
    "mesh_shape": {"data": 1, "model": 1},
}
TABLES = (
    "betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
    "sqrt_one_minus_alphas_cumprod", "posterior_variance",
    "posterior_log_variance_clipped", "posterior_mean_coef1", "posterior_mean_coef2",
)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_schedule_tables():
    args = ("linear-var", 0.1, 0.0001, 0.02, 5)
    js = j_schedule(*args, beta_fixed_value=1e-4)
    ts = t_schedule(*args, beta_fixed_value=1e-4)
    assert ts.steps == js.steps and ts.betas.dtype == torch.float64
    betas = j_betas(5, np.linspace(0.1 * 0.0001, 0.1 * 0.02, 5, dtype=np.float64))
    betas[0] = 1e-4
    np.testing.assert_allclose(ts.betas.numpy(), betas, rtol=0, atol=1e-12)
    acp = np.cumprod(1.0 - betas)
    np.testing.assert_allclose(ts.alphas_cumprod.numpy(), acp, rtol=0, atol=1e-12)
    for name in TABLES:
        # cast to the JAX package's float32, the tables are equal bit for bit
        np.testing.assert_array_equal(
            getattr(ts, name).to(torch.float32).numpy(), np.asarray(getattr(js, name)), err_msg=name
        )


def test_denoiser_matches_apply_dnn():
    in_dims, out_dims, emb = [1600, 64], [64, 1600], 10
    params = init_dnn(jax.random.PRNGKey(1), in_dims, out_dims, emb)
    net = Denoise(in_dims, out_dims, emb)
    from_jax_params(net, _np_tree(params))
    rng = np.random.default_rng(0)
    x = (rng.random((32, 1600)) < 0.02).astype(np.float32)
    t = rng.integers(0, 5, 32)
    np.testing.assert_allclose(
        timestep_embedding(torch.from_numpy(t), 10).numpy(), np.asarray(j_temb(jnp.asarray(t), 10)), rtol=1e-6, atol=1e-7
    )
    ref = np.asarray(apply_dnn(params, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        out = net(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_from_jax_params_checks_names_and_shapes():
    params = _np_tree(init_dnn(jax.random.PRNGKey(1), [40, 8], [8, 40], 4))
    net = Denoise([40, 8], [8, 40], 4)
    bad = {**params, "emb_layer": {"w": params["emb_layer"]["w"]}}
    with pytest.raises(KeyError, match="emb_layer.bias"):
        from_jax_params(net, bad)
    bad = {**params, "emb_layer": {**params["emb_layer"], "w": np.zeros((4, 5), np.float32)}}
    with pytest.raises(ValueError, match="emb_layer.weight"):
        from_jax_params(net, bad)


@pytest.fixture(scope="module")
def pair():
    """The JAX DiffMM with its initial parameters and the port's DiffMM
    holding the same parameters, on the same data."""
    jc, tc = JConfig("DiffMM", "tiny", dict(SLICE)), TConfig("DiffMM", "tiny", dict(SLICE))
    j_splits, t_splits = JDataset(jc).split(), TDataset(tc).split()
    jtd, ttd = j_train(j_splits[0]), t_train(t_splits[0], CPU)
    jm, tm = JDiffMM(jc, jtd), TDiffMM(tc, ttd)
    params = jm.init_params(jax.random.PRNGKey(0))
    from_jax_params(tm, _np_tree(params))
    return dict(jc=jc, tc=tc, j_splits=j_splits, t_splits=t_splits, jm=jm, tm=tm, params=params)


def test_interaction_vectors_and_p_sample_users(pair):
    jm, tm, params = pair["jm"], pair["tm"], pair["params"]
    users = np.arange(0, 300, 3)
    jx = jm.interaction_vectors(jnp.asarray(users, jnp.int32))
    tx = tm.interaction_vectors(torch.from_numpy(users))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    ref = np.asarray(jm.p_sample_users(params["denoise_image"], jx))
    with torch.no_grad():
        out = tm.p_sample_users(tm.denoise_image, tx).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_rebuild_ui_graph_and_init_state(pair):
    jm, tm = pair["jm"], pair["tm"]
    top = np.random.default_rng(4).integers(0, 1600, (300, 1))
    jg = jm.rebuild_ui_graph(jnp.asarray(top, jnp.int32), jax.random.PRNGKey(0))
    tg = tm.rebuild_ui_graph(torch.from_numpy(top))
    np.testing.assert_array_equal(tg.rows.numpy(), np.asarray(jg["rows"]))
    np.testing.assert_array_equal(tg.cols.numpy(), np.asarray(jg["cols"]))
    np.testing.assert_allclose(tg.vals.numpy(), np.asarray(jg["vals"]), rtol=0, atol=1e-6)
    assert tg.nnz == 2 * 300 + tg.n_rows and bool((tg.row_ptr[1:] > tg.row_ptr[:-1]).all())
    js, ts = jm.init_state(jax.random.PRNGKey(0)), tm.init_state()
    for m in ("image_ui", "text_ui"):
        np.testing.assert_array_equal(ts[m].rows.numpy(), np.asarray(js[m]["rows"]))
        np.testing.assert_allclose(ts[m].vals.numpy(), np.asarray(js[m]["vals"]), rtol=0, atol=1e-6)


def test_forward_mm_matches(pair):
    jm, tm, params = pair["jm"], pair["tm"], pair["params"]
    rng = np.random.default_rng(6)
    tops = {m: rng.integers(0, 1600, (300, 1)) for m in ("image_ui", "text_ui")}
    jstate = {m: jm.rebuild_ui_graph(jnp.asarray(t, jnp.int32), None) for m, t in tops.items()}
    tstate = {m: tm.rebuild_ui_graph(torch.from_numpy(t)) for m, t in tops.items()}
    ju, ji = jm.forward_MM(params, jstate)
    with torch.no_grad():
        tu, ti = tm.forward_MM(tstate)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-5, atol=1e-5)


def _quick_start_masks(train_ds):
    """The popular-item and warm-user masks as the JAX quick_start computes them."""
    item_counts = np.bincount(train_ds.table.items, minlength=train_ds.item_num)
    unique_items = np.argsort(-item_counts, kind="stable")
    unique_items = unique_items[item_counts[unique_items] > 0]
    pop_mask = np.zeros(train_ds.item_num, bool)
    pop_mask[unique_items[: int(len(unique_items) * 0.2)]] = True
    return pop_mask, np.bincount(train_ds.table.users, minlength=train_ds.user_num) > 5


def _jax_eval_topk(trainer, params, ed):
    if trainer._eval_fn is None:
        trainer._eval_fn = trainer._build_eval_fn()
    n_chunks = ed.users.shape[0] // trainer.eval_batch_size
    dense = trainer._dense_mask(ed, planar=trainer._fused_eval)
    users, mask = trainer._shard_eval_inputs(ed.users, dense)
    return np.asarray(trainer._eval_fn(params, trainer._state, users, mask, n_chunks, dense_mask=True))


def test_serving_slice_matches(pair):
    """regenerate → evaluate(valid) → evaluate(test, is_test=True) in both
    packages: the same regenerated graphs, top-50 lists equal wherever the
    score gap exceeds 1e-5, every metric within 1e-4."""
    jc, tc, jm, tm, params = pair["jc"], pair["tc"], pair["jm"], pair["tm"], pair["params"]
    (j_tr, j_va, j_te), (t_tr, t_va, t_te) = pair["j_splits"], pair["t_splits"]
    pop, warm = group_masks(t_tr, CPU)
    ref_pop, ref_warm = _quick_start_masks(j_tr)
    np.testing.assert_array_equal(pop.numpy(), ref_pop)
    np.testing.assert_array_equal(warm.numpy(), ref_warm)
    jc["pop_mask"], jc["warm_mask"] = jnp.asarray(ref_pop), jnp.asarray(ref_warm)
    tc["pop_mask"], tc["warm_mask"] = pop, warm

    jtr, ttr = JTrainer(jc, jm), TTrainer(tc, tm)
    key = jax.random.PRNGKey(0)
    jtr._state = jm.init_state(key)
    jtr._build_diffusion_phase()
    jtr._state = {**jtr._state, **jtr._regenerate(params, key)}
    ttr.regenerate()
    for m in ("image_ui", "text_ui"):
        np.testing.assert_array_equal(ttr.state[m].cols.numpy(), np.asarray(jtr._state[m]["cols"]))
        np.testing.assert_allclose(ttr.state[m].vals.numpy(), np.asarray(jtr._state[m]["vals"]), rtol=0, atol=1e-6)

    bs = int(jc["eval_batch_size"])
    with torch.no_grad():
        u, i = tm.eval_artifacts(ttr.state)
    for j_split, t_split, is_test in ((j_va, t_va, False), (j_te, t_te, True)):
        jed, ted = j_eval(j_split, j_tr, bs), t_eval(t_split, t_tr, bs, CPU)
        j_top = _jax_eval_topk(jtr, params, jed)
        t_top = ttr.eval_topk(ted).numpy()
        assert t_top.shape == j_top.shape == (ted.users.shape[0], 50)
        # where the lists differ, the two choices must be a near-tie
        scores = (u[ted.users] @ i.T).numpy()
        rows = np.arange(len(scores))[:, None]
        gap = np.abs(scores[rows, t_top] - scores[rows, j_top])
        assert (t_top != j_top).mean() < 0.01 and gap[t_top != j_top].max(initial=0.0) <= 1e-5
        j_res = jtr.evaluate(params, jed, is_test=is_test)
        t_res = ttr.evaluate(ted, is_test=is_test)
        assert t_res.keys() == j_res.keys()
        for k in j_res:
            assert abs(t_res[k] - j_res[k]) <= 1e-4 + 1e-9, (k, t_res[k], j_res[k])


def test_evaluator_matches_on_a_tiny_catalog(tmp_path):
    """48 items < top-50: lists end in -1 padding. Metrics, group metrics
    and the saved top-k CSV match the JAX evaluator's."""
    from genmmrec_tpu.engine.evaluator import TopKEvaluator as JEval
    from genmmrec_tpu_torch.engine.evaluator import TopKEvaluator as TEval

    over = {"save_recommended_topk": True}
    jc, tc = JConfig("DiffMM", "tiny", dict(over)), TConfig("DiffMM", "tiny", dict(over))
    jc["recommend_topk"], tc["recommend_topk"] = str(tmp_path / "jax"), str(tmp_path / "torch")
    (j_tr, _, j_te), (t_tr, _, t_te) = JDataset(jc).split(), TDataset(tc).split()
    jed, ted = j_eval(j_te, j_tr, 64), t_eval(t_te, t_tr, 64, CPU)
    pop, warm = group_masks(t_tr, CPU)
    rng = np.random.default_rng(9)
    top = np.stack([rng.permutation(48) for _ in range(ted.users.shape[0])])
    top = np.concatenate([top, np.full((len(top), 2), -1)], axis=1)
    j_res = JEval(jc).evaluate(
        jnp.asarray(top, jnp.int32), jed, jnp.asarray(pop.numpy()), jnp.asarray(warm.numpy()), is_test=True
    )
    t_res = TEval(tc).evaluate(torch.from_numpy(top), ted, pop, warm, is_test=True)
    assert t_res.keys() == j_res.keys()
    for k in j_res:
        assert abs(t_res[k] - j_res[k]) <= 1e-4 + 1e-9, (k, t_res[k], j_res[k])
    (j_csv,), (t_csv,) = (tmp_path / "jax").iterdir(), (tmp_path / "torch").iterdir()
    assert t_csv.read_text() == j_csv.read_text()
