"""The port's GenRecV1, its trainer and its slice against the JAX package,
on the CPU.

Tiny GenRecV1 widened to 200 users x 600 items, a denoiser of 2 layers,
batches of 64 users: 4 user batches, 56 padding slots. The JAX
parameters go into the port through ``from_jax_params``. Every JAX draw
(dropout masks, timesteps, flip uniforms, the debias plane, the edge
dropout) is rebuilt from the JAX keys and handed to the port. Tolerances:
one float32 forward or loss 1e-5 relative; gradients 1e-4 relative plus
1e-5 of the tensor's largest entry; an epoch of Adam steps 1e-3 of
each leaf's update in norm and 1e-4 at all but 1e-3 of a leaf's entries,
its Adam moments within the gradient bound at every entry; binary
samples, graphs' edges and top-k lists equal. At this width every top-k
of the JAX package is ``lax.top_k`` (5 groups, not more than 2k), whose
ties go to the lower index as K3's do.
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
from genmmrec_tpu.engine.diffusion_trainers import GenRecV1Trainer as JTrainer
from genmmrec_tpu.engine.trainer import get_trainer as j_get_trainer
from genmmrec_tpu.models.genrecv1 import GenRecV1 as JGenRecV1
from genmmrec_tpu_torch.config import Config as TConfig
from genmmrec_tpu_torch.data.arrays import build_eval_data as t_eval
from genmmrec_tpu_torch.data.arrays import interaction_vectors
from genmmrec_tpu_torch.data.arrays import build_train_data as t_train
from genmmrec_tpu_torch.data.dataset import RecDataset as TDataset
from genmmrec_tpu_torch.engine import diffusion_trainers as tdt
from genmmrec_tpu_torch.engine.evaluator import group_masks
from genmmrec_tpu_torch.engine.trainer import Trainer as TBaseTrainer
from genmmrec_tpu_torch.engine.trainer import get_trainer
from genmmrec_tpu_torch.interop import from_jax_params, jax_tree_by_name, params_by_jax_name
from genmmrec_tpu_torch.models import get_model
from genmmrec_tpu_torch.models.genrecv1 import GenRecV1 as TGenRecV1
from test_torch_diffmm import _bf16_ordinal, _jax_eval_topk
from test_torch_flip import p_sample_draws, q_sample_draws

CPU = torch.device("cpu")
SLICE = {
    "synthetic_n_users": 200,
    "synthetic_n_items": 600,
    "synthetic_n_inters": 3000,
    "train_batch_size": 64,
    "num_layers": 2,
    "save_recommended_topk": False,
    "mesh_shape": {"data": 1, "model": 1},
}
TABLE_KEYS = ("img_member", "txt_member", "txt_counts", "txt_minfreq", "img_labels", "txt_labels")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _below(key, shape, p):
    """``jax.random.bernoulli(key, p, shape)`` as a bool tensor."""
    return _t(np.asarray(jax.random.uniform(key, shape)) < np.float32(p))


def _dropout_masks(key, n_items, d):
    """The keep masks of the JAX forward's four dropouts under ``key``."""
    out = {}
    for m, k in zip(("image", "text"), jax.random.split(key)):
        out[m] = tuple(_below(kk, (n_items, d), 0.9) for kk in jax.random.split(k))
    return out


def _edge_keep(key, n_edges, n_nodes, keep_rate):
    """The two masks of ``rebuild_ui_graph``'s paired dropout under ``key``."""
    k_ui, k_loop = jax.random.split(key)
    return _below(k_ui, (n_edges,), keep_rate), _below(k_loop, (n_nodes,), keep_rate)


def _diffusion_draws(key, shape, steps):
    """``diffusion_losses``' draws under ``key``."""
    k_t, k_q, k_gen = jax.random.split(key, 3)
    q_noise, q_flip = q_sample_draws(k_q, shape)
    gen_init, gen_steps = p_sample_draws(k_gen, shape, steps, steps)
    ts = _t(jax.random.randint(k_t, (shape[0],), 0, steps)).long()
    return dict(ts=ts, q_noise=q_noise, q_flip=q_flip, gen_init=gen_init, gen_steps=gen_steps)


def _generate_draws(key, shape, steps, sampling_steps):
    init, step_u = p_sample_draws(key, shape, steps, sampling_steps)
    return dict(gen_init=init, gen_steps=step_u)


@pytest.fixture(scope="module")
def pair():
    """Both packages' GenRecV1 on the same data with the JAX initial
    parameters, and one generated graph (random top-k, the JAX dropout
    masks) in both states."""
    jc, tc = JConfig("GenRecV1", "tiny", dict(SLICE)), TConfig("GenRecV1", "tiny", dict(SLICE))
    j_splits, t_splits = JDataset(jc).split(), TDataset(tc).split()
    jm, tm = JGenRecV1(jc, j_train(j_splits[0])), TGenRecV1(tc, t_train(t_splits[0], CPU))
    params = jax.jit(jm.init_params)(jax.random.PRNGKey(0))
    from_jax_params(tm, _np_tree(params))
    top = np.random.default_rng(3).integers(0, jm.n_items, (jm.n_users, jm.rebuild_k))
    key = jax.random.PRNGKey(4)
    jstate = {"image_ui": jax.jit(jm.rebuild_ui_graph)(jnp.asarray(top, jnp.int32), key)}
    keep = _edge_keep(key, top.size, jm.n_users + jm.n_items, jm.keep_rate)
    tstate = {"image_ui": tm.rebuild_ui_graph(_t(top), keep=keep)}
    return dict(jc=jc, tc=tc, j_splits=j_splits, t_splits=t_splits, jm=jm, tm=tm, params=params,
                jstate=jstate, tstate=tstate)


@pytest.fixture
def fresh(pair):
    from_jax_params(pair["tm"], _np_tree(pair["params"]))
    pair["tm"].zero_grad(set_to_none=True)
    return pair


def test_setup_graphs_match(pair):
    """The adjacency, R (duplicates as edges), the two KNN graphs and the
    generated graph equal the JAX package's."""
    jm, tm = pair["jm"], pair["tm"]
    for name in ("norm_adj", "R", "image_II", "text_II"):
        jg, tg = getattr(jm, name), getattr(tm, name)
        assert (tg.n_rows, tg.n_cols) == (jg.n_rows, jg.n_cols), name
        np.testing.assert_array_equal(tg.rows.numpy(), np.asarray(jg.rows), err_msg=name)
        np.testing.assert_array_equal(tg.cols.numpy(), np.asarray(jg.cols), err_msg=name)
        np.testing.assert_allclose(tg.vals.numpy(), np.asarray(jg.vals), rtol=1e-6, atol=0, err_msg=name)
    assert tm.R.nnz == tm.data.n_inter and not tm.R.symmetric and not tm.image_II.symmetric
    jg, tg = pair["jstate"]["image_ui"], pair["tstate"]["image_ui"]
    np.testing.assert_array_equal(tg.cols.numpy(), np.asarray(jg["cols"]))
    np.testing.assert_allclose(tg.vals.numpy(), np.asarray(jg["vals"]), rtol=0, atol=1e-6)
    js, ts = jm.init_state(jax.random.PRNGKey(5)), tm.init_state(torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(ts["image_ui"].rows.numpy(), np.asarray(js["image_ui"]["rows"]))
    # the self loops' values depend on the dropout draws; the user-item edges are 0
    off = ts["image_ui"].rows != ts["image_ui"].cols
    assert bool((ts["image_ui"].vals[off] == 0).all())


def test_parameters_round_trip(pair):
    """Every leaf of the JAX tree, norms (``g``/``b``) and ``ca_bv`` included,
    has its parameter, and the values come back unchanged."""
    ref = jax_tree_by_name(_np_tree(pair["params"]))
    got = params_by_jax_name(pair["tm"])
    assert got.keys() == ref.keys()
    for name in ("rec/image_residual/bn/g", "rec/common2/w", "denoise_image/layers/1/ca_bv", "denoise_image/out_ln/b"):
        assert name in got
    for name in ref:
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
    groups = pair["tm"].param_groups()
    assert len(groups["rec"]) + len(groups["denoise_image"]) == len(got)
    assert len(groups["denoise_image"]) == sum(1 for k in got if k.startswith("denoise_image/"))


@pytest.mark.parametrize("dropout", [False, True])
def test_forward_matches(fresh, dropout):
    jm, tm, params = fresh["jm"], fresh["tm"], fresh["params"]
    key = jax.random.PRNGKey(6) if dropout else None
    jc, js = jax.jit(jm.forward)(params, fresh["jstate"], key)
    masks = _dropout_masks(key, jm.n_items, jm.latdim) if dropout else None
    with torch.no_grad():
        tc, ts = tm.forward(fresh["tstate"], masks)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-6)


def _batch(jm, B=64, seed=7):
    rng = np.random.default_rng(seed)
    users, pos, neg = rng.integers(0, jm.n_users, B), rng.integers(0, jm.n_items, B), rng.integers(0, jm.n_items, B)
    w = np.ones(B, np.float32)
    w[-9:] = 0.0
    jb = {"users": jnp.asarray(users, jnp.int32), "pos": jnp.asarray(pos, jnp.int32),
          "neg": jnp.asarray(neg, jnp.int32), "weight": jnp.asarray(w)}
    tb = {"users": _t(users).long(), "pos": _t(pos).long(), "neg": _t(neg).long(), "weight": _t(w)}
    return jb, tb


def _assert_grads(tm, jax_grads, prefix):
    """Each port gradient against ``jax.grad``'s; a parameter the loss does
    not read has no gradient in the port and a zero one in JAX. The bias of
    a linear layer that feeds a batch norm has a gradient that is zero but
    for rounding (the norm subtracts the mean): in both packages it must
    stay below 1e-4 of the largest gradient of the same layer's weight."""
    ref = jax_tree_by_name(_np_tree(jax_grads))
    named = dict(tm.named_parameters())
    checked = 0
    for jname, pname in zip(params_by_jax_name(tm), named):
        if not jname.startswith(prefix):
            continue
        g = named[pname].grad
        if g is None:
            assert not ref[jname].any(), jname
            continue
        if jname.startswith("rec/") and (jname.endswith("/lin/b") or jname == "rec/common1/b"):
            bound = 1e-4 * np.abs(ref[jname[:-1] + "w"]).max()
            assert np.abs(ref[jname]).max() <= bound and g.abs().max().item() <= bound, jname
            checked += 1
            continue
        scale = np.abs(ref[jname]).max()
        np.testing.assert_allclose(g.numpy(), ref[jname], rtol=1e-4, atol=1e-5 * scale, err_msg=jname)
        checked += 1
    return checked


def test_loss_and_rec_grads_match(fresh):
    """The BPR + InfoNCE loss and every ``rec`` gradient, with the JAX
    forward's dropout masks; the denoiser and the three weights the forward
    does not read get no gradient."""
    jm, tm, params = fresh["jm"], fresh["tm"], fresh["params"]
    jb, tb = _batch(jm)
    key = jax.random.PRNGKey(8)
    (ref, _), grads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(params, fresh["jstate"], jb, key)
    total, parts = tm.loss(fresh["tstate"], tb, masks=_dropout_masks(key, jm.n_items, jm.latdim))
    total.backward()
    np.testing.assert_allclose(total.item(), float(ref), rtol=1e-5)
    assert len(parts) == 1 and parts[0] is total
    assert _assert_grads(tm, grads, "rec/") > 30
    unread = [tm.fusion_weight, tm.img_weight, tm.txt_weight, *tm.denoise_image.parameters()]
    assert all(p.grad is None for p in unread)


def test_diffusion_losses_and_denoiser_grads_match(fresh):
    """Phase 1's loss of a batch with padded zero rows, and the denoiser's
    gradient (the contrastive term's p_sample chain carries none)."""
    jm, tm, params = fresh["jm"], fresh["tm"], fresh["params"]
    users = np.minimum(np.arange(0, 64) * 3, jm.n_users - 1)
    x_start = np.array(jm.interaction_vectors(jnp.asarray(users, jnp.int32)))
    x_start[-6:] = 0.0
    i_emb = np.asarray(params["rec"]["item_id_embedding"])
    img, txt = np.asarray(jm.get_image_feats(params)), np.asarray(jm.get_text_feats(params))
    key = jax.random.PRNGKey(9)

    inputs = (x_start, i_emb, img, txt)

    def jloss(dn):
        return jm.diffusion_losses(dn, *map(jnp.asarray, inputs), key)

    ref, grads = jax.jit(jax.value_and_grad(jloss))(params["denoise_image"])
    loss = tm.diffusion_losses(*map(_t, inputs), draws=_diffusion_draws(key, x_start.shape, jm.steps))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
    assert _assert_grads(tm, {"denoise_image": grads}, "denoise_image/") > 40
    assert tm.denoise_image.time_emb1.weight.grad is None
    np.testing.assert_array_equal(
        interaction_vectors(tm.data, _t(users).long()).numpy(), np.asarray(jm.interaction_vectors(jnp.asarray(users)))
    )


def test_generate_matches(fresh):
    """The blended matrix equal (binary, from the same uniforms) and the
    probabilities within float32 rounding."""
    jm, tm, params = fresh["jm"], fresh["tm"], fresh["params"]
    users = np.arange(0, 128)
    x_start = np.asarray(jm.interaction_vectors(jnp.asarray(users, jnp.int32)))
    key = jax.random.PRNGKey(10)
    j_blend, j_probs = jax.jit(jm.generate)(params["denoise_image"], jnp.asarray(x_start), key)
    t_blend, t_probs = tm.generate(_t(x_start), draws=_generate_draws(key, x_start.shape, jm.steps, jm.sampling_steps))
    np.testing.assert_allclose(t_probs.numpy(), np.asarray(j_probs), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(t_blend.numpy(), np.asarray(j_blend))
    assert (t_blend.numpy() != x_start).any()


def test_get_trainer():
    assert get_trainer("GenRecV1") is tdt.GenRecV1Trainer
    assert get_trainer("DiffMM") is tdt.DiffMMTrainer
    assert get_trainer("MVDiff") is tdt.MVDiffTrainer
    assert get_trainer("LightGCN") is TBaseTrainer and get_trainer(None) is TBaseTrainer
    for name in ("GenRecV1", "DiffMM", "MVDiff", "LightGCN"):
        assert get_trainer(name).__name__ == j_get_trainer(name).__name__
    assert get_model("GenRecV1") is TGenRecV1


# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def trainers(pair):
    """Both packages' trainers on the pair; the port's debias tables are the
    JAX package's (the two k-means draw differently)."""
    jc, tc = pair["jc"], pair["tc"]
    (j_tr, _, _), (t_tr, _, _) = pair["j_splits"], pair["t_splits"]
    pop, warm = group_masks(t_tr, CPU)
    jc["pop_mask"], jc["warm_mask"] = jnp.asarray(pop.numpy()), jnp.asarray(warm.numpy())
    tc["pop_mask"], tc["warm_mask"] = pop, warm
    jtr, ttr = JTrainer(jc, pair["jm"]), tdt.GenRecV1Trainer(tc, pair["tm"])
    own = ttr.debias_tables
    ttr.debias_tables = {k: _t(np.asarray(jtr._debias_tables[k])) for k in TABLE_KEYS}
    for k in ("img_labels", "txt_labels"):
        ttr.debias_tables[k] = ttr.debias_tables[k].long()
    jtr._build_diffusion_phase()
    return dict(jtr=jtr, ttr=ttr, own_tables=own)


def test_trainer_clusters_at_construction(pair, trainers):
    """The port's own clustering: tiny's cluster counts (DEFAULT_K: image 18,
    text 59), one label per item, tables of the JAX package's shapes."""
    own, jt = trainers["own_tables"], trainers["jtr"]._debias_tables
    assert own["img_labels"].shape == (pair["tm"].n_items,)
    assert int(own["img_labels"].max()) + 1 == 18 and int(own["txt_labels"].max()) + 1 == 59
    for k in TABLE_KEYS:
        assert tuple(own[k].shape) == tuple(np.asarray(jt[k]).shape), k
    assert trainers["ttr"].cluster_s > 0.0


def test_diffusion_epoch_matches_jax(fresh, trainers):
    """Phase 1 from the same parameters and the JAX package's plan: the
    epoch's loss and the denoiser after it; ``rec`` bit-equal.

    Leaf by leaf: the update agrees with JAX's within 1e-3 of its norm;
    fewer than 1e-3 of the entries leave 1e-4 relative + 1e-6 (so a leaf of
    fewer than 1,000 entries matches entry by entry), and none is apart by
    more than nb · lr; Adam's two moments (the running mean of the
    gradients and of their squares) agree with optax's at every entry
    within the gradient bound of the one-batch tests, 1e-4 relative + 1e-5
    of the leaf's largest. So an entry past the entry bound has gradients
    that agree to rounding: it is an entry whose moments are small beside
    its leaf's largest, where that bound allows a larger relative
    difference, and Adam divides each entry by its own scale."""
    jm, tm, params = fresh["jm"], fresh["tm"], fresh["params"]
    jtr, ttr = trainers["jtr"], trainers["ttr"]
    B, nb = jtr.train_batch_size, jtr._n_user_batches
    key = jax.random.PRNGKey(11)
    new_params, j_opt, loss_sum = jtr._diffusion_epoch(params, jtr._diff_opt.init(params["denoise_image"]), key)
    k_perm, k_scan = jax.random.split(key)
    perm = np.asarray(jax.random.permutation(k_perm, nb * B)).reshape(nb, B)
    draws = [_diffusion_draws(k, (B, jm.n_items), jm.steps) for k in jax.random.split(k_scan, nb)]
    assert nb == 4 and (perm >= jm.n_users).sum() == nb * B - jm.n_users > 0

    rec_before = {k: v.copy() for k, v in params_by_jax_name(tm).items() if k.startswith("rec/")}
    ttr._build_diffusion_phase()
    losses = ttr._diffusion_epoch(plan={"users": _t(perm).long(), "draws": draws})
    assert losses.shape == (nb, 1)
    np.testing.assert_allclose(losses.sum().item(), float(loss_sum), rtol=1e-4)
    after = params_by_jax_name(tm)
    for k, v in rec_before.items():
        np.testing.assert_array_equal(after[k], v, err_msg=k)

    def by_name(tree):
        return jax_tree_by_name(_np_tree({"denoise_image": tree}))

    ref, start = by_name(new_params["denoise_image"]), by_name(params["denoise_image"])
    j_moments = {"mu": by_name(j_opt[0].mu), "nu": by_name(j_opt[0].nu)}
    port = dict(tm.named_parameters())
    lr = float(fresh["tc"]["learning_rate"])
    assert ref.keys() == {k for k in after if k.startswith("denoise_image/")}
    for k, r in ref.items():
        step_jax, step_port = r - start[k], after[k] - start[k]
        apart = np.linalg.norm(step_port - step_jax)
        assert apart <= 1e-3 * np.linalg.norm(step_jax), (k, apart, np.linalg.norm(step_jax))
        diff = np.abs(after[k] - r)
        off = diff > 1e-4 * np.abs(r) + 1e-6
        assert off.sum() < 1e-3 * off.size, (k, np.argwhere(off).tolist())
        assert diff.max() <= nb * lr, (k, diff.max())
        parts = k.split("/")
        leaf = parts[:-1] + [{"w": "weight", "b": "bias"}.get(parts[-1], parts[-1])]
        state = ttr.optimizers["denoise_image"].state[port[".".join(leaf)]]
        for m, j in j_moments.items():
            want, got = j[k], state[m].numpy()
            bound = 1e-4 * np.abs(want) + 1e-5 * np.abs(want).max()
            assert (np.abs(got - want) <= bound).all(), (k, m, np.argwhere(np.abs(got - want) > bound).tolist())


@pytest.fixture(scope="module")
def regenerated(pair, trainers):
    """One regeneration in both packages from the initial parameters, the
    JAX draws handed to the port."""
    jm, params = pair["jm"], pair["params"]
    jtr, ttr = trainers["jtr"], trainers["ttr"]
    from_jax_params(pair["tm"], _np_tree(params))
    key = jax.random.PRNGKey(12)
    jtr._state = {**jm.init_state(key), **jtr._regenerate(params, key)}
    B, nb = jtr.train_batch_size, jtr._n_user_batches
    k_gen, k_debias, k_drop = jax.random.split(key, 3)
    shape = (B, jm.n_items)
    plan = {
        "gen": [_generate_draws(k, shape, jm.steps, jm.sampling_steps) for k in jax.random.split(k_gen, nb)],
        "sampled": [_below(k, shape, jtr.config["sample_ratio"]) for k in jax.random.split(k_debias, nb)],
        "keep": _edge_keep(k_drop, jm.n_users * jm.rebuild_k, jm.n_users + jm.n_items, jm.keep_rate),
    }
    ttr.regenerate(plan=plan)
    return jtr, ttr


def test_regeneration_matches_jax(regenerated):
    """The generated graph (gen_topk blend, interest debias, top rebuild_k,
    paired dropout) equal to the JAX package's: edges equal, values within
    1e-6."""
    jtr, ttr = regenerated
    jg, tg = jtr._state["image_ui"], ttr.state["image_ui"]
    np.testing.assert_array_equal(tg.rows.numpy(), np.asarray(jg["rows"]))
    np.testing.assert_array_equal(tg.cols.numpy(), np.asarray(jg["cols"]))
    np.testing.assert_allclose(tg.vals.numpy(), np.asarray(jg["vals"]), rtol=0, atol=1e-6)
    assert tg.symmetric and tg.nnz == 2 * jtr.model.n_users * 10 + tg.n_rows


@pytest.mark.parametrize("split", ["valid", "test"])
def test_evaluate_float32_matches_jax(pair, regenerated, split):
    """evaluate in float32 after the regeneration: the top-50 lists equal
    wherever the two packages' scores are apart by more than 1e-5, every
    metric within 1e-4."""
    jtr, ttr = regenerated
    (j_tr, j_va, j_te), (t_tr, t_va, t_te) = pair["j_splits"], pair["t_splits"]
    j_split, t_split = (j_va, t_va) if split == "valid" else (j_te, t_te)
    bs, is_test = int(pair["jc"]["eval_batch_size"]), split == "test"
    jed, ted = j_eval(j_split, j_tr, bs), t_eval(t_split, t_tr, bs, CPU)
    params = pair["params"]
    j_top, t_top = _jax_eval_topk(jtr, params, jed), ttr.eval_topk(ted).numpy()
    assert t_top.shape == j_top.shape == (ted.users.shape[0], 50)
    with torch.no_grad():
        u, i = pair["tm"].full_embeddings(ttr.state)
    scores = (u[ted.users] @ i.T).numpy()
    rows = np.arange(len(scores))[:, None]
    gap = np.abs(scores[rows, t_top] - scores[rows, j_top])
    assert (t_top != j_top).mean() < 0.01 and gap[t_top != j_top].max(initial=0.0) <= 1e-5
    j_res, t_res = jtr.evaluate(params, jed, is_test=is_test), ttr.evaluate(ted, is_test=is_test)
    assert t_res.keys() == j_res.keys()
    for k in j_res:
        assert abs(t_res[k] - j_res[k]) <= 1e-4 + 1e-9, (k, t_res[k], j_res[k])


def test_evaluate_bfloat16_matches_jax(pair, regenerated):
    """evaluate(valid) with bfloat16 scores on the same models and graph: the
    port's trainer takes the fused route (``has_cache``, as the JAX
    trainer decides it: GenRecV1 defines ``full_embeddings``; K5's plain
    versions here), the JAX trainer its unfused bf16 route. Scores of the
    two lists within one bf16 ulp, lists equal but for < 5 % of entries,
    metrics within 5e-3."""
    from genmmrec_tpu.engine.trainer import Trainer as JBaseTrainer

    jtr, ttr = regenerated
    jm, tm, params = pair["jm"], pair["tm"], pair["params"]
    (j_tr, j_va, _), (t_tr, t_va, _) = pair["j_splits"], pair["t_splits"]
    jm.eval_dtype, tm.eval_dtype = jnp.dtype(jnp.bfloat16), torch.bfloat16
    try:
        jb, tb = JBaseTrainer(pair["jc"], jm), TBaseTrainer(pair["tc"], tm)
        jb._state, tb.state = jtr._state, ttr.state
        bs = int(pair["jc"]["eval_batch_size"])
        jed, ted = j_eval(j_va, j_tr, bs), t_eval(t_va, t_tr, bs, CPU)
        j_res, t_res = jb.evaluate(params, jed), tb.evaluate(ted)
        j_top, t_top = _jax_eval_topk(jb, params, jed), tb.eval_topk(ted).numpy()
        assert not jb._fused_eval
    finally:
        jm.eval_dtype, tm.eval_dtype = jnp.dtype(jnp.float32), torch.float32
    for k in j_res:
        assert abs(t_res[k] - j_res[k]) <= 5e-3, (k, t_res[k], j_res[k])
    with torch.no_grad():
        u, i = tm.full_embeddings(tb.state)
    plane = (u[ted.users].bfloat16() @ i.bfloat16().T).float().numpy()
    rows = np.arange(len(plane))[:, None]
    apart = np.abs(_bf16_ordinal(plane[rows, t_top]) - _bf16_ordinal(plane[rows, j_top]))
    assert apart.max() <= 1 and (t_top != j_top).mean() < 0.05
