"""The port's multi-device layer (``genmmrec_tpu_torch/parallel``) against the
JAX package's ``parallel/mesh.py``, on the CPU.

In this process (the JAX package on the 8 virtual CPU devices of the
conftest): ``local_topk`` + ``merge_topk`` over 4 item shards against JAX's
``sharded_topk`` on its 2 × 4 mesh, at (16, 64) and at the Amazon-elec
width; tie-heavy and masked planes against ``lax.top_k`` and K3's plain
version; the qualifying parameters of ``shard_model_params`` against the
JAX leaves that come out sharded, for every model of the zoo; ``build_mesh``'s shapes and its error;
the gradient-carrying collectives in a world of one rank; the trainer of
each of the last 25 models to take a data axis on a ``{data: 2}`` layout.

In one spawned world of 4 gloo ranks a session (``parallel.dryrun.
mesh_checks``, which imports neither JAX nor these tests): BPR, LightGCN,
LayerGCN, BM3, DualGNN, MGCN and, one epoch each, DiffMM, GenRecV1,
DiffRec, MVDiff and RFBM3 fitted on a 2 × 2 mesh against one rank
(parameters within 2e-4, metrics within 2e-3, the JAX package's bounds), a
BPR checkpoint and resume on the mesh against one rank, a BPR fit whose
batch does not split over a ``{data: 2}`` mesh against one rank, one batch
split over the data axis of DiffMM, GenRecV1 and each of the 20
graph-CF, multimodal, message-passing and multimodal graph models against
``jax.grad`` at the global batch (built, and held, as their parity tests
build and hold it), one batch of each of the diffusion recommenders,
MVDiff and the 19 RF models against one rank of the port (13 of them also
against ``jax.grad``), and one training batch of FREEDOM, RFBM3, LightGCN
and DiffMM on a model axis alone against one rank. Wherever the world has
a model axis its ranks hold the tables as their rows
(``parallel.mesh.hold_table_rows``). On the item split of the diffusion
denoisers: one phase-1 batch of DiffMM, GenRecV1 and MVDiff (MVDiff's
phase 3) on a model axis alone against one rank (DiffMM from the JAX
parameters and draws, also against ``jax.grad``), and DiffMM's phase 1 and
regeneration on the 2 × 2 mesh against one rank. Spawned processes build
the batch cases while the ranks fit. Then ``dryrun_multigpu(4)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from genmmrec_tpu.config import Config as JConfig
from genmmrec_tpu.data.arrays import build_train_data as j_train
from genmmrec_tpu.data.dataset import RecDataset as JDataset
from genmmrec_tpu.models import get_model as j_get_model
from genmmrec_tpu.parallel import mesh as jmesh
from genmmrec_tpu_torch.config import Config as TConfig
from genmmrec_tpu_torch.data.arrays import build_train_data as t_train
from genmmrec_tpu_torch.data.dataset import RecDataset as TDataset
from genmmrec_tpu_torch.engine.trainer import get_trainer
from genmmrec_tpu_torch.interop import jax_tree_by_name, params_by_jax_name
from genmmrec_tpu_torch.models import get_model as t_get_model
from genmmrec_tpu_torch.ops.topk import grouped_topk_plain
from genmmrec_tpu_torch.parallel import dryrun, launch
from genmmrec_tpu_torch.parallel import mesh as pm
from test_torch_rf_hosts import _one_torch_thread  # noqa: F401 (autouse: one torch thread a test worker)

CPU = torch.device("cpu")
FIT = {
    "epochs": 2,
    "save_recommended_topk": False,
    "hyper_parameters": ["seed"],
    "topk": [5, 10],
    "metrics": ["Recall", "NDCG"],
    "valid_metric": "Recall@10",
}


def _jax_mesh():
    return JMesh(np.asarray(jax.devices()[:8]).reshape(2, 4), ("data", "model"))


def _shards_topk(scores, k, S, packed_mask=None):
    """``local_topk`` on each of S item shards, then ``merge_topk``: the
    route of ``sharded_topk`` without the gather."""
    t = torch.as_tensor(scores)
    vals, idx = [], []
    for lo, hi in pm.shard_bounds(t.shape[1], S):
        mask = None if packed_mask is None else packed_mask[:, lo // 8 : lo // 8 + -(-(hi - lo) // 8)].contiguous()
        v, i = pm.local_topk(t[:, lo:hi].contiguous(), k, lo, mask)
        vals.append(v)
        idx.append(i)
    return pm.merge_topk(torch.cat(vals, 1), torch.cat(idx, 1), k)


@pytest.mark.parametrize("shape,k", [((16, 64), 7), ((8, 63001), 20)])
def test_sharded_topk_pieces_match_jax(shape, k):
    scores = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    v_ref, i_ref = jax.jit(lambda s: jmesh.sharded_topk(s, k, _jax_mesh()))(jnp.asarray(scores))
    v, i = _shards_topk(scores, k, 4)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), rtol=1e-6)
    # the ids are determined where a value occurs once in its row
    once = (scores[:, None, :] == v.numpy()[:, :, None]).sum(-1) == 1
    assert once.mean() > 0.9
    np.testing.assert_array_equal(i.numpy()[once], np.asarray(i_ref)[once])


@pytest.mark.parametrize("n,k,S", [(200, 30, 4), (100, 25, 4), (63001, 50, 4), (64, 16, 2)])
def test_sharded_topk_ties_in_global_order(n, k, S):
    """A plane of a few integer values: the values' multiset equals
    ``lax.top_k``'s and the ids follow its rule (larger value, then lower
    id), also where the last shard is narrower than k (pad slots)."""
    scores = np.random.default_rng(n).integers(0, 4, (12, n)).astype(np.float32)
    v_ref, i_ref = jax.lax.top_k(jnp.asarray(scores), k)
    v, i = _shards_topk(scores, k, S)
    for row in range(scores.shape[0]):
        assert sorted(v[row].tolist()) == sorted(np.asarray(v_ref[row]).tolist())
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))


def test_sharded_topk_with_packed_mask_equals_plain():
    rng = np.random.default_rng(1)
    n, k = 1000, 40
    scores = torch.as_tensor(rng.integers(0, 6, (16, n)).astype(np.float32))
    pad = -(-n // 128) * 128
    dense = rng.random((16, pad)) < 0.3
    dense[:, n:] = True
    dense[3, : n - 10] = True  # a row with fewer unmasked columns than k
    packed = torch.as_tensor(np.packbits(dense, axis=1, bitorder="little"))
    v_ref, i_ref = grouped_topk_plain(scores, k, packed_mask=packed)
    v, i = _shards_topk(scores, k, 4, packed)
    assert torch.equal(v, v_ref) and torch.equal(i, i_ref)


def _pair(name, shape):
    jc, tc = JConfig(name, "tiny", {"mesh_shape": shape}), TConfig(name, "tiny", {"mesh_shape": shape})
    jm = j_get_model(name)(jc, j_train(JDataset(jc).split()[0]))
    tm = t_get_model(name)(tc, t_train(TDataset(tc).split()[0], CPU))
    return jm, tm


def test_build_mesh_shapes_and_error():
    jdev = jax.devices()[:8]
    for shape in ({"data": 2, "model": 4}, {"data": 1, "model": 2}, None):
        mesh = pm.build_mesh({"mesh_shape": shape}, world=8)
        j = jmesh.build_mesh({"mesh_shape": shape}, devices=jdev)
        assert mesh.shape == dict(j.shape)
    assert pm.build_mesh({"mesh_shape": None}) is None
    assert pm.build_mesh({"mesh_shape": {"data": 1, "model": 1}}) is None
    with pytest.raises(ValueError, match="exceeds 8 devices"):
        pm.build_mesh({"mesh_shape": {"data": 4, "model": 4}}, world=8)
    with pytest.raises(ValueError, match="exceeds 8 devices"):
        jmesh.build_mesh({"mesh_shape": {"data": 4, "model": 4}}, devices=jdev)
    # one process: a shape of more ranks than it has is no longer ignored
    with pytest.raises(ValueError, match="exceeds 1 devices"):
        pm.build_mesh({"mesh_shape": {"data": 2, "model": 1}})
    assert pm.backend_for("cpu", 4) == "gloo"
    assert [pm.Mesh(2, 2, r).data_rank for r in range(4)] == [0, 0, 1, 1]
    assert [pm.Mesh(2, 2, r).model_rank for r in range(4)] == [0, 1, 0, 1]
    assert pm.shard_bounds(63001, 4) == [(0, 15752), (15752, 31504), (31504, 47256), (47256, 63001)]
    assert pm.takes_sharded(48, 10, pm.Mesh(1, 2)) and not pm.takes_sharded(48, 25, pm.Mesh(1, 2))


def _one_rank_group(fn):
    """``fn(mesh)`` inside a gloo process group of one rank (a 1 × 1 mesh
    with its groups), which is then destroyed."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{launch._free_port()}", world_size=1, rank=0)
    try:
        g = dist.new_group([0])
        return fn(pm.Mesh(1, 1, 0, "gloo", g, g))
    finally:
        dist.destroy_process_group()


def test_gradient_collectives_in_a_world_of_one():
    def run(mesh):
        x = torch.randn(5, 3, dtype=torch.float64, requires_grad=True)
        w = torch.randn(5, 3, dtype=torch.float64)
        (pm.gather_rows(x, mesh) * w).sum().backward()
        g_gather = x.grad.clone()
        x.grad = None
        (pm.sum_over((x * x).sum(), mesh) * 3.0).backward()
        return x.detach(), w, g_gather, x.grad

    x, w, g_gather, g_sum = _one_rank_group(run)
    assert torch.equal(g_gather, w)
    assert torch.equal(g_sum, 6.0 * x)


# the diffusion recommenders, MVDiff and the RF family: the last 25 models
# to take a data axis
DIFF_MODELS = ("LD4MRec", "DDRM", "DiffGraph", "MCDRec", "CoDMR")
RF_MODELS = ("RFGUME", "RFGUMETime", "GenRecBM3", "RFMRec")
RF_HOSTS = ("RFBM3", "RFBPR_remove", "RFLightGCN_remove", "RFLayerGCN_remove", "RFVBPR", "RFFREEDOM", "RFLATTICE",
            "RFMMGCN", "RFGRCN", "RFDualGNN", "RFCOHESION", "RFMGCN", "RFSMORE", "RFLGMRec", "RFPGL")
LAST_MODELS = (*DIFF_MODELS, "MVDiff", *RF_MODELS, *RF_HOSTS)


@pytest.mark.parametrize("name", LAST_MODELS)
def test_data_axis_admits_every_model(name):
    """Every model builds its trainer on a ``{data: 2}`` layout; training
    on a layout without the process groups of its ranks raises."""
    config = TConfig(name, "tiny", {"save_recommended_topk": False})
    td = t_train(TDataset(config).split()[0], CPU)
    trainer = get_trainer(name)(config, t_get_model(name)(config, td), mesh=pm.Mesh(2, 1))
    assert trainer.mesh.shape == {"data": 2, "model": 1}
    with pytest.raises(ValueError, match="process group"):
        trainer._build_train_step(td)


# -- the 4-rank world ---------------------------------------------------------
def _diffmm_case():
    from test_torch_train import TRAIN, _batch, _np_tree

    jc = JConfig("DiffMM", "tiny", dict(TRAIN))
    jm = j_get_model("DiffMM")(jc, j_train(JDataset(jc).split()[0]))
    params = jm.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(6)
    tops = {m: rng.integers(0, jm.n_items, (jm.n_users, 1)) for m in ("image_ui", "text_ui")}
    jstate = {m: jm.rebuild_ui_graph(jnp.asarray(t, jnp.int32), None) for m, t in tops.items()}
    users, pos, neg, w = _batch(jm.n_users, jm.n_items)
    jb = {"users": jnp.asarray(users, jnp.int32), "pos": jnp.asarray(pos, jnp.int32),
          "neg": jnp.asarray(neg, jnp.int32), "weight": jnp.asarray(w)}
    (ref, _), grads = jax.value_and_grad(jm.loss, has_aux=True)(params, jstate, jb, None)
    case = dict(model="DiffMM", overrides=dict(TRAIN), params=_np_tree(params),
                state={m: (t, {}) for m, t in tops.items()},
                batch={"users": users, "pos": pos, "neg": neg, "weight": w}, draws={})
    return case, float(ref), jax_tree_by_name(_np_tree(grads))


def _genrecv1_case():
    from test_torch_genrecv1 import SLICE, _batch, _dropout_masks, _edge_keep, _np_tree

    jc = JConfig("GenRecV1", "tiny", dict(SLICE))
    jm = j_get_model("GenRecV1")(jc, j_train(JDataset(jc).split()[0]))
    params = jax.jit(jm.init_params)(jax.random.PRNGKey(0))
    top = np.random.default_rng(3).integers(0, jm.n_items, (jm.n_users, jm.rebuild_k))
    key = jax.random.PRNGKey(4)
    jstate = {"image_ui": jax.jit(jm.rebuild_ui_graph)(jnp.asarray(top, jnp.int32), key)}
    keep = _edge_keep(key, top.size, jm.n_users + jm.n_items, jm.keep_rate)
    jb, tb = _batch(jm)
    mkey = jax.random.PRNGKey(8)
    (ref, _), grads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(params, jstate, jb, mkey)
    case = dict(model="GenRecV1", overrides=dict(SLICE), params=_np_tree(params),
                state={"image_ui": (top, {"keep": keep})}, batch={k: v.numpy() for k, v in tb.items()},
                draws={"masks": _dropout_masks(mkey, jm.n_items, jm.latdim)})
    return case, float(ref), jax_tree_by_name(_np_tree(grads))


def _diffmm_phase1_case():
    """DiffMM's phase 1 on tiny at ``PHASE1``'s one batch from the JAX
    parameters and the JAX package's draws, as ``test_diffusion_epoch_
    matches_jax`` builds it → (the case of ``dryrun.phase1_batch``: the
    parameters and the plan; the JAX batch's losses; ``jax.grad`` of each
    modality's loss by JAX name)."""
    from test_torch_train import _jax_diffusion_draws, _np_tree

    jc = JConfig("DiffMM", "tiny", dict(PHASE1["DiffMM"]))
    jm = j_get_model("DiffMM")(jc, j_train(JDataset(jc).split()[0]))
    params = jm.init_params(jax.random.PRNGKey(0))
    B, U = int(PHASE1["DiffMM"]["train_batch_size"]), jm.n_users
    nb = -(-U // B)
    users = np.asarray(jax.random.permutation(jax.random.PRNGKey(21), nb * B)).reshape(nb, B)
    plan = {"users": users}
    valid = jnp.asarray(users[0] < U, jnp.float32)
    x_start = jm.interaction_vectors(jnp.minimum(jnp.asarray(users[0], jnp.int32), U - 1)) * valid[:, None]
    feats = {"image": jm.get_image_feats(params), "text": jm.get_text_feats(params)}
    losses, grads = [], {}
    for m, km in zip(("image", "text"), jax.random.split(jax.random.PRNGKey(22))):
        for name, a in zip(("ts", "noise", "keep"), _jax_diffusion_draws(km, B, jm.n_items, jm.steps)):
            plan[f"{name}_{m}"] = np.repeat(a[None], nb, axis=0)

        def modal_loss(p):
            d, g = jm.diffusion_losses(p, x_start, params["rec"]["iEmbeds"], feats[m], km)
            return ((d * valid).sum() + jm.e_loss * (g * valid).sum()) / jnp.maximum(valid.sum(), 1.0)

        loss, g = jax.value_and_grad(modal_loss)(params[f"denoise_{m}"])
        losses.append(float(loss))
        grads.update(jax_tree_by_name(_np_tree({f"denoise_{m}": g})))
    return {"params": _np_tree(params), "plan": plan}, np.asarray(losses), grads


def _reference(name, jm, params, jstate, key, overrides, draws=None, graphs=None):
    """A ``batch_grads`` case of ``name`` at the global batch of the models'
    parity tests (96 rows, 7 of them padding), and a function that takes
    ``jax.grad`` of the JAX loss there → (case, () → (loss, gradients by
    JAX name))."""
    from test_torch_cf import _batch, _np_tree

    users, pos, neg, w = _batch(jm.n_users, jm.n_items)
    jb = {"users": jnp.asarray(users, jnp.int32), "pos": jnp.asarray(pos, jnp.int32),
          "neg": jnp.asarray(neg, jnp.int32), "weight": jnp.asarray(w)}
    case = dict(model=name, overrides=dict(overrides), params=_np_tree(params), jax_state=_np_tree(jstate),
                graphs=graphs or {}, batch={"users": users, "pos": pos, "neg": neg, "weight": w}, draws=draws or {})

    def grad():
        (ref, _), grads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(params, jstate, jb, key)
        return float(ref), jax_tree_by_name(_np_tree(grads))

    return case, grad


def _jax_model(name, overrides):
    """The JAX model on the tiny data of ``overrides`` and its parameters
    from key 0 and initial state from key 1, as the parity tests draw them."""
    jc = JConfig(name, "tiny", dict(overrides))
    jm = j_get_model(name)(jc, j_train(JDataset(jc).split()[0]))
    return jm, jax.jit(jm.init_params)(jax.random.PRNGKey(0)), jm.init_state(jax.random.PRNGKey(1))


def _graph_edges(rows, cols, vals, n_rows, n_cols):
    return dict(rows=np.asarray(rows), cols=np.asarray(cols), vals=np.asarray(vals), n_rows=n_rows, n_cols=n_cols)


def _cf_case(name):
    """As ``test_torch_cf`` builds it: LayerGCN on its even epoch's pruned
    graph, SELFCFED_LGN's dropout masks from the loss key."""
    import test_torch_cf as cf

    jm, params, jstate = _jax_model(name, cf.SLICE)
    key, draws = jax.random.PRNGKey(7), {}
    if name == "LayerGCN":
        jstate = jm.pre_epoch(params, jstate, jax.random.PRNGKey(40), 0)
    if name == "SELFCFED_LGN":
        k_u, k_i = jax.random.split(key)
        draws["keep"] = tuple(cf._t(np.asarray(jax.random.bernoulli(k, 1.0 - jm.dropout, (n, jm.latent_size))))
                              for k, n in ((k_u, jm.n_users), (k_i, jm.n_items)))
    return _reference(name, jm, params, jstate, key, cf.SLICE, draws)


def _mm_case(name):
    """As ``test_torch_mm_models`` builds it: FREEDOM on one pruned graph,
    BM3's four dropout masks from the loss key."""
    import test_torch_mm_models as mm

    jm, params, jstate = _jax_model(name, mm.SLICE)
    key, draws = jax.random.PRNGKey(7), {}
    if name == "FREEDOM":
        jstate = jm.pre_epoch(params, jstate, jax.random.PRNGKey(40), 0)
    if name == "BM3":
        d = jm.embedding_dim
        shapes = {"user": (jm.n_users, d), "item": (jm.n_items, d), "text": (jm.n_items, d), "image": (jm.n_items, d)}
        keys = dict(zip(("user", "item", "text", "image"), jax.random.split(key, 4)))
        draws["keep"] = {m: mm._below(keys[m], shapes[m], 1.0 - jm.dropout) for m in shapes}
    return _reference(name, jm, params, jstate, key, mm.SLICE, draws)


def _mp_case(name):
    """As ``test_torch_mp_models`` builds it: the JAX user graph in the
    port, COHESION on one pruned graph, MVGAE's draws from the loss key."""
    import test_torch_mp_models as mp

    jm, params, jstate = _jax_model(name, mp.SLICE)
    key, draws, graphs = jax.random.PRNGKey(7), {}, {}
    if name in mp.USER_GRAPH_MODELS:
        nbrs, w = np.asarray(jm.user_nbrs), np.asarray(jm.user_nbr_w)
        rows = np.repeat(np.arange(jm.n_users), nbrs.shape[1])
        graphs["user_graph"] = _graph_edges(rows, nbrs.reshape(-1), w.reshape(-1), jm.n_users, jm.n_users)
    if name == "COHESION":
        jm.dropout = 0.3
        jstate = jm.pre_epoch(params, jstate, jax.random.PRNGKey(40), 0)
        jm.dropout = 0.0
    if name == "MVGAE":
        draws = mp._mvgae_draws(jm, key)
    return _reference(name, jm, params, jstate, key, mp.SLICE, draws, graphs)


def _mmg_case(name):
    """As ``test_torch_mm_graph_models`` builds it: the widened attention
    layers, DAMRS on the JAX item graphs, PGL on one pruned graph, every
    JAX draw of the loss key."""
    import test_torch_mm_graph_models as mmg

    jm, params, jstate = _jax_model(name, mmg.SLICE)
    params = mmg._widened(name, params)
    if name == "PGL":
        jstate = jm.pre_epoch(params, jstate, jax.random.PRNGKey(40), 0)
    graphs = {}
    if name == "DAMRS":
        for g in ("image_adj", "text_adj", "session_adj"):
            jg = getattr(jm, g)
            graphs[g] = _graph_edges(jg.rows, jg.cols, jg.vals, jg.n_rows, jg.n_cols)
    key = jax.random.PRNGKey(7)
    draws = mmg._draws(name, jm, key, 96)
    return _reference(name, jm, params, jstate, key, mmg.SLICE, draws, graphs)


def _diff_case(name):
    """As ``test_torch_diffusion_models`` builds it: MCDRec at 20 steps,
    LD4MRec on the JAX ``svds`` table, every JAX draw of the loss key."""
    import test_torch_diffusion_models as dm

    over = {**dm.SLICE, **dm.OVERRIDES.get(name, {})}
    jm, params, jstate = _jax_model(name, over)
    key = jax.random.PRNGKey(7)
    case, grad = _reference(name, jm, params, jstate, key, over, dm._draws(name, jm, jstate, key, 96))
    if name == "LD4MRec":
        case["attrs"] = {"user_svd_emb": np.asarray(jm.user_svd_emb)}
    return case, grad


def _mvdiff_case(name):
    """As ``test_torch_mvdiff`` builds it: the dropout masks of the four
    projection stacks from the loss key."""
    import test_torch_mvdiff as mv

    jm, params, jstate = _jax_model(name, mv.SLICE)
    key = jax.random.PRNGKey(7)
    keep = {m: {part: [mv._bern(jax.random.fold_in(key, i), 0.9, (jm.n_items, layer["lin"]["w"].shape[0]))
                       for i, layer in enumerate(params["rec"][f"{m}_{part}"])] for part in ("residual", "modal")}
            for m in ("image", "text")}
    return _reference(name, jm, params, jstate, key, mv.SLICE, {"keep": keep})


def _rf_case(name, extra=None):
    """As the RF parity tests build it: the widened attention layers, the
    JAX user graph, RFLGMRec's target draws of ``PRNGKey(0)``, RFMRec at 2
    × 64, the model's own initial state, the host's draws and the RF
    draws of the loss key; ``extra`` overrides the config."""
    import test_torch_rf_hosts as rh
    import test_torch_rf_models as rm

    over = {**rh.SLICE, **rm.NARROW.get(name, {}), **(extra or {})}
    jm, params, jstate = _jax_model(name, over)
    params = rh.widened(name, params)
    key, B, N = jax.random.PRNGKey(7), 96, jm.n_users + jm.n_items
    if name in RF_MODELS:
        draws = rm._port_draws({"name": name, "jm": jm, "tm": jm})(key, B)
    else:
        draws = {**rh.host_draws(name, jm, key, B), "rf_draws": rh.rf_draws(jm.rf_cfg, jax.random.fold_in(key, 1317), N, B)}
    graphs = {}
    if name in rh.USER_GRAPH_HOSTS:
        nbrs, w = np.asarray(jm.user_nbrs), np.asarray(jm.user_nbr_w)
        rows = np.repeat(np.arange(jm.n_users), nbrs.shape[1])
        graphs["user_graph"] = _graph_edges(rows, nbrs.reshape(-1), w.reshape(-1), jm.n_users, jm.n_users)
    case, grad = _reference(name, jm, params, jstate, key, over, draws, graphs)
    del case["jax_state"]
    case["init_state"] = True
    if name == "RFLGMRec":
        case["attrs"] = {"repr_draws": rh.lgmrec_draws(jm, jax.random.PRNGKey(0))}
    return case, grad


def _reflow_case(name):
    """RFBM3 (``_rf_case``) in epoch 1 of a 2-RF switch at epoch 1: the flow
    learns the reflow pair of the RF draws' start noise, ``(z0,
    generate(z0))``, which every rank builds alike. No JAX reference."""
    case = _rf_case("RFBM3", {"use_2rf": True, "rf_2rf_transition_epoch": 1})[0]
    case["state_values"] = {"rf_epoch": 1}
    rf_draws = case["draws"]["rf_draws"]
    rf_draws["z0"] = rf_draws.pop("x0")
    return case, None


# the last 25 models' cases, and RFBM3 past the 2-RF switch; the 13 held
# against jax.grad too (the six diffusion models, the four standalone RF
# models and one host of each RF host file: the 15 hosts share one mixin,
# and each host's one-rank loss is held to JAX by its parity test)
LAST_CASES = {**{name: _diff_case for name in DIFF_MODELS}, "MVDiff": _mvdiff_case,
              **{name: _rf_case for name in (*RF_MODELS, *RF_HOSTS)}, "RFBM3_2rf": _reflow_case}
LAST_AGAINST_JAX = (*DIFF_MODELS, "MVDiff", *RF_MODELS, "RFBM3", "RFDualGNN", "RFLGMRec")


def _last_zero_grads(name):
    """The gradients that are zero but for rounding, each with its weight's,
    as the models' parity tests list them."""
    import test_torch_diffusion_models as dm
    import test_torch_mvdiff as mv
    import test_torch_rf_hosts as rh

    return mv.ZERO_GRADS if name == "MVDiff" else {**dm.ZERO_GRADS, **rh.ZERO_GRADS}.get(name, {})


# the four families whose losses split over the data axis
FAMILIES = {
    **{name: _cf_case for name in ("LayerGCN", "SELFCFED_LGN")},
    **{name: _mm_case for name in ("VBPR", "BM3", "FREEDOM", "ItemKNNCBF")},
    **{name: _mp_case for name in ("MMGCN", "GRCN", "DualGNN", "DRAGON", "COHESION", "MVGAE")},
    **{name: _mmg_case for name in ("GUME", "LATTICE", "MGCN", "LGMRec", "SMORE", "PGL", "SLMRec", "DAMRS")},
}


# every model of the zoo
ALL_MODELS = ("BPR", "LightGCN", "DiffMM", "GenRecV1", "DiffRec", *FAMILIES, *LAST_MODELS)


@pytest.mark.parametrize("name", ALL_MODELS)
def test_shard_model_params_names_match_jax(name):
    shape = {"data": 2, "model": 4}
    jm, tm = _pair(name, shape)
    assert jm.n_items % 4 == 0
    # the rule reads the leaves' shapes alone: zeros of the init's shapes
    shapes = jax.eval_shape(jm.init_params, jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(lambda leaf: np.zeros(leaf.shape, leaf.dtype), shapes)
    sharded = jmesh.shard_model_params(jm, params, jmesh.build_mesh(JConfig(name, "tiny", {"mesh_shape": shape})))
    flags = jax.tree_util.tree_map(lambda leaf: "model" in str(leaf.sharding.spec), sharded)
    j_names = {k for k, on in jax_tree_by_name(flags).items() if on}
    to_jax = dict(zip(dict(tm.named_parameters()), params_by_jax_name(tm)))
    port = pm.shard_model_params(tm, pm.build_mesh({"mesh_shape": shape}, world=8))
    assert {to_jax[n] for n in port} == j_names
    # ItemKNNCBF learns nothing
    assert bool(j_names) == (name != "ItemKNNCBF")
    assert all(hi - lo == dict(tm.named_parameters())[n].shape[0] // 4 for n, (lo, hi) in port.items())
    if name == "DiffRec":
        last = len(tm.dnn.out_layers) - 1
        assert {f"dnn.out_layers.{last}.weight", f"dnn.out_layers.{last}.bias"} <= set(port)


def _family_zero_grads():
    """The gradients that are zero but for rounding, each with its weight's,
    as the families' parity tests list them."""
    import test_torch_mm_graph_models as mmg
    import test_torch_mm_models as mm

    return {**mm.ZERO_GRADS, **mmg.ZERO_GRADS}


# one 2 x 2 fit of each family against one rank
FAMILY_FITS = ("LayerGCN", "BM3", "DualGNN", "MGCN")
# a batch that does not split over a {data: 2} mesh
ODD_BATCH = {**FIT, "train_batch_size": 63}

STEPS = {name: {"save_recommended_topk": False} for name in ("FREEDOM", "RFBM3", "LightGCN", "DiffMM")}
# fitted one epoch on the 2 x 2 mesh: phase 1, the regeneration and the
# loss history over the data axis (dryrun.DRYRUN); MVDiff's four phases,
# with every pick of phase 4 kept (its order among the picks whose
# self-similarity products tie near 1.0 follows float32 rounding, and at
# keep_rate < 1 the slot order decides which picks the dropout keeps:
# ROADMAP Queue 3); RFBM3 with no warm-up, so that the flow reaches the
# scores and the "rf" AdamW steps
DIFFUSION = ("DiffMM", "GenRecV1", "DiffRec")
ONE_EPOCH = {**{name: dryrun.DRYRUN for name in DIFFUSION}, "MVDiff": {**dryrun.DRYRUN, "keep_rate": 1.0},
             "RFBM3": {**dryrun.DRYRUN, "rf_warmup_epochs": 0, "rf_loss_weight": 0.2}}
# parameters whose gradients are zero but for rounding: biases in front of
# a batch norm, and MVDiff's time-embedding layers and first feature
# layers, whose nearly constant time-embedding inputs reach a batch norm.
# Adam turns their rounding into steps of the learning rate, so their
# function is held by the metrics
BN_FED_BIAS = ("lin.bias", "common1.bias", "enc1.bias", "enc2.bias")
CANCELLED = {"MVDiff": ("emb.weight", "emb.bias", "enc1.weight")}


# one phase-1 batch on the model axis's item split (the 64 tiny users in one
# batch); MVDiff's phase over (B, n_items) vectors is its phase 3
PHASE1 = {"DiffMM": dryrun.DRYRUN, "GenRecV1": dryrun.DRYRUN, "MVDiff": {**dryrun.DRYRUN, "keep_rate": 1.0}}


# the processes that build the batch cases and their JAX references
CASE_PROCESSES = 3


def _case_process(names, queue):
    """One process of the world's set-up (spawned): puts each case of
    ``names`` on ``queue`` as it is built, then the JAX loss and gradients
    of each (None for a case held against one rank alone)."""
    import conftest  # noqa: F401 (this session's JAX settings)

    torch.set_num_threads(1)
    makers = {**FAMILIES, **LAST_CASES}
    grads = {}
    for name in names:
        case, grads[name] = makers[name](name)
        queue.put(("case", name, case))
    for name, grad in grads.items():
        queue.put(("ref", name, grad() if name in FAMILIES or name in LAST_AGAINST_JAX else (None, None)))


def _pump(queue, procs, got: dict, until) -> None:
    """Messages of ``queue`` into ``got`` (kind -> name -> value) until
    ``until()``; raises if a process of ``procs`` fails."""
    import queue as q

    while not until():
        try:
            kind, name, value = queue.get(timeout=5)
        except q.Empty:
            failed = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
            if failed:
                raise RuntimeError(f"a case process exited with code {failed[0]}")
            continue
        got[kind][name] = value


def _world(tmp):
    """The world's results, and each batch case with its JAX loss and
    gradients. The ranks start at once; ``CASE_PROCESSES`` processes build
    the families' and the last 25 models' cases while the ranks fit, hand
    them over in a file (``dryrun.handed_over``), and take their JAX
    gradients while the ranks run the batches."""
    import multiprocessing
    import os
    from concurrent.futures import ThreadPoolExecutor

    names = [*FAMILIES, *LAST_CASES]
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_case_process, args=(names[i::CASE_PROCESSES], queue))
             for i in range(CASE_PROCESSES)]
    for p in procs:
        p.start()
    got = {"case": {}, "ref": {}}
    handover = str(tmp / "batches.pt")
    spec = {"fits": {"BPR": FIT, "LightGCN": FIT, **ONE_EPOCH, **{name: FIT for name in FAMILY_FITS}},
            "resumes": {"BPR": {**FIT, "checkpoint_dir": str(tmp)}}, "batches": handover,
            "steps": STEPS, "data_fits": {"BPR": ODD_BATCH}, "phase1": PHASE1,
            "phase1_cases": {"phase1_DiffMM": "DiffMM"}, "regenerations": {"DiffMM": dryrun.DRYRUN}}
    with ThreadPoolExecutor(1) as pool:
        running = pool.submit(launch.run, dryrun.mesh_checks, {"data": 2, "model": 2}, "cpu", (spec,))
        batches = None
        try:
            cases = {"DiffMM": _diffmm_case(), "GenRecV1": _genrecv1_case(), "phase1_DiffMM": _diffmm_phase1_case()}
            _pump(queue, procs, got, lambda: len(got["case"]) == len(names))
            batches = {**{k: c[0] for k, c in cases.items()}, **got["case"]}
        finally:
            # the ranks wait for this file; None tells them the cases failed
            torch.save(batches, handover + ".part")
            os.replace(handover + ".part", handover)
            if batches is None:
                for p in procs:
                    p.kill()
        _pump(queue, procs, got, lambda: len(got["ref"]) == len(names))
        out = running.result()
    for p in procs:
        p.join()
    cases.update({name: (got["case"][name], *got["ref"][name]) for name in names})
    return out, cases


@pytest.fixture(scope="session")
def world(tmp_path_factory, worker_id):
    """Every scenario of ``mesh_checks`` in one world of 4 gloo ranks, with
    the JAX references of the batch cases: run once a session, and shared
    with the other pytest-xdist workers through a file under a lock."""
    if worker_id == "master":
        return _world(tmp_path_factory.mktemp("mesh_saved"))
    from filelock import FileLock

    path = tmp_path_factory.getbasetemp().parent / "torch_mesh_world.pt"
    with FileLock(str(path) + ".lock"):
        if not path.is_file():
            torch.save(_world(tmp_path_factory.mktemp("mesh_saved")), path)
        return torch.load(path, weights_only=False)


@pytest.mark.parametrize("name", ["BPR", "LightGCN", *ONE_EPOCH, *FAMILY_FITS])
def test_mesh_fit_matches_one_rank(world, name):
    """The parameters within the JAX test's 2e-4 and the metrics within its
    2e-3. A bias that feeds a batch norm (GenRecV1's and MVDiff's,
    ``BN_FED_BIAS``) and MVDiff's layers of ``CANCELLED`` have gradients
    that are zero but for rounding, which Adam turns into full steps: they
    are left out of the parameters, their function held by the metrics."""
    out, _ = world
    s_ref, v_ref, t_ref, p_ref = dryrun.fit(name, ONE_EPOCH.get(name, FIT), CPU)
    s_sh, v_sh, t_sh, p_sh = out[f"fit_{name}"]
    assert p_ref.keys() == p_sh.keys()
    for k in p_ref:
        if k.endswith(BN_FED_BIAS + CANCELLED.get(name, ())):
            continue
        np.testing.assert_allclose(p_sh[k], p_ref[k], atol=2e-4, rtol=2e-4, err_msg=k)
    assert abs(s_ref - s_sh) < 2e-3
    for ref, got in ((v_ref, v_sh), (t_ref, t_sh)):
        assert ref.keys() == got.keys()
        assert all(abs(ref[k] - got[k]) < 2e-3 for k in ref), (ref, got)


def test_mesh_checkpoint_and_resume_match_one_rank(world, tmp_path):
    """Rank 0's checkpoint holds the moments gathered whole from the model
    ranks, and a fit resumed from it on the mesh (each rank taking its rows
    of them) ends where one rank's resumed fit ends."""
    states, params = world[0]["resume_BPR"]
    ref_states, ref_params = dryrun.fit_and_resume("BPR", {**FIT, "checkpoint_dir": str(tmp_path)}, CPU)
    assert ref_states.keys() == states.keys() == {"main"}
    got, ref = states["main"], ref_states["main"]
    assert got["count"] == ref["count"] and got["state"].keys() == ref["state"].keys()
    for i, st in ref["state"].items():
        for k in ("mu", "nu"):
            assert got["state"][i][k].shape == st[k].shape
            np.testing.assert_allclose(got["state"][i][k].numpy(), st[k].numpy(), rtol=2e-4, atol=2e-6)
    for k in ref_params:
        np.testing.assert_allclose(params[k], ref_params[k], atol=2e-4, rtol=2e-4, err_msg=k)


@pytest.mark.parametrize("name", ["DiffMM", "GenRecV1"])
def test_data_axis_batch_gradients_match_jax(world, name):
    """The loss summed over the data axis and the summed gradients equal
    ``jax.grad`` of the JAX loss at the global batch (the tolerances of the
    models' parity tests; a batch-norm-fed bias's gradient, zero but for
    rounding, within 1e-4 of its weight's largest)."""
    out, cases = world
    got = out[f"grad_{name}"]
    case, ref_loss, ref_grads = cases[name]
    np.testing.assert_allclose(got["loss"], ref_loss, rtol=1e-5)
    config = TConfig(name, "tiny", dict(case["overrides"]))
    tm = t_get_model(name)(config, t_train(TDataset(config).split()[0], CPU))
    checked = 0
    for pname, jname in zip(dict(tm.named_parameters()), params_by_jax_name(tm)):
        if not jname.startswith("rec/"):
            assert not got["grads"][pname].any(), pname  # the denoisers play no part
            continue
        g, r = got["grads"][pname], ref_grads[jname]
        if name == "GenRecV1" and (jname.endswith("/lin/b") or jname == "rec/common1/b"):
            bound = 1e-4 * np.abs(ref_grads[jname[:-1] + "w"]).max()
            assert np.abs(g).max() <= bound, jname
        else:
            np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-5 * np.abs(r).max(), err_msg=jname)
        checked += 1
    assert checked >= 5


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_data_axis_batches_of_four_families_match_jax(world, name):
    """Each model of the graph-CF, multimodal, message-passing and
    multimodal graph families: the loss summed over the data axis and the
    summed gradients equal ``jax.grad`` of the JAX loss at the global batch
    (the tolerances of the models' parity tests). A gradient that is zero
    but for rounding stays within 1e-5 of its weight's largest; one the loss
    does not read is zero."""
    out, cases = world
    got = out[f"grad_{name}"]
    case, ref_loss, ref_grads = cases[name]
    np.testing.assert_allclose(got["loss"], ref_loss, rtol=1e-5)
    config = TConfig(name, "tiny", dict(case["overrides"]))
    tm = t_get_model(name)(config, t_train(TDataset(config).split()[0], CPU))
    names = dict(zip(params_by_jax_name(tm), dict(tm.named_parameters())))
    assert names.keys() == ref_grads.keys()
    zero = _family_zero_grads().get(name, {})
    for jname, pname in names.items():
        g, r = got["grads"][pname], ref_grads[jname]
        if jname in zero:
            assert np.abs(g).max() <= 1e-5 * np.abs(ref_grads[zero[jname]]).max(), jname
            continue
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-5 * np.abs(r).max(), err_msg=jname)


@pytest.mark.parametrize("name", LAST_CASES)
def test_data_axis_batches_of_last_25_match_one_rank(world, name):
    """The diffusion recommenders, MVDiff and the RF family (and RFBM3 past
    the 2-RF switch): the loss summed over the data axis within rtol 1e-5
    of the same batch on one rank of the port (in this process), every
    summed gradient within rtol 1e-4 plus 1e-5 of its tensor's largest, the
    state the batch writes (LD4MRec's loss history) within 1e-6 of its
    largest. A gradient that is zero but for rounding stays within 1e-5 of
    its weight's largest. The 13 models of ``LAST_AGAINST_JAX`` are held to
    ``jax.grad`` of the JAX loss at the global batch within the same
    bounds."""
    out, cases = world
    got = out[f"grad_{name}"]
    case, ref_loss, ref_grads = cases[name]
    one = dryrun.batch_grads(case, CPU)
    names = dict(zip(one["jax_names"], one["grads"]))
    zero = _last_zero_grads(case["model"])
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-5)
    assert got["state"].keys() == one["state"].keys()
    for k, v in one["state"].items():
        np.testing.assert_allclose(got["state"][k], v, rtol=0, atol=1e-6 * np.abs(v).max(), err_msg=k)
    refs = [one["grads"]]
    if name in LAST_AGAINST_JAX:
        np.testing.assert_allclose(got["loss"], ref_loss, rtol=1e-5)
        assert names.keys() == ref_grads.keys()
        refs.append({pname: ref_grads[jname] for jname, pname in names.items()})
    for ref in refs:
        for jname, pname in names.items():
            g, r = got["grads"][pname], ref[pname]
            if jname in zero:
                assert np.abs(g).max() <= 1e-5 * np.abs(ref[names[zero[jname]]]).max(), jname
                continue
            np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-5 * np.abs(r).max(), err_msg=jname)


def test_batch_that_does_not_split_trains_as_one_rank(world):
    """``train_batch_size`` 63 on a ``{data: 2}`` mesh: the batch stays whole
    on both ranks, nothing is summed over the axis, and the fit ends where
    one rank's does."""
    _, _, _, p_sh = world[0]["data_fit_BPR"]
    _, _, _, p_ref = dryrun.fit("BPR", ODD_BATCH, CPU)
    assert p_ref.keys() == p_sh.keys()
    for k in p_ref:
        np.testing.assert_allclose(p_sh[k], p_ref[k], atol=2e-4, rtol=2e-4, err_msg=k)


@pytest.mark.parametrize("name", sorted(STEPS))
def test_model_axis_batch_matches_one_rank(world, name):
    """Under ``{data: 1, model: 2}`` each rank holds its rows of the tables
    (their gradients and moments too) and reads them whole: the parameters
    after one batch (DiffMM's: of its BPR + InfoNCE epoch), gathered whole,
    equal one rank's."""
    out, _ = world
    ref = dryrun.one_batch(name, STEPS[name], CPU)
    got = out[f"step_{name}"]
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-7, err_msg=k)


def test_dryrun_multigpu_on_the_cpu():
    out = dryrun.dryrun_multigpu(4, device="cpu")
    assert set(out) == {"DiffMM", "GenRecV1"}


# the parameters that a phase-1 batch steps on the item split, by model
SPLIT = {"DiffMM": [f"denoise_{m}.out_layers.0.{w}" for m in ("image", "text") for w in ("weight", "bias")],
         "GenRecV1": ["denoise_image.out2.weight", "denoise_image.out2.bias"],
         "MVDiff": [f"denoise_{m}.up.2.{p}" for m in ("image", "text") for p in ("lin.weight", "lin.bias", "bn.g",
                                                                               "bn.bias")]}


@pytest.mark.parametrize("name", sorted(PHASE1))
def test_model_axis_phase1_matches_one_rank(world, name):
    """One phase-1 batch (MVDiff: phase 3) on ``{data: 1, model: 2}``, each
    rank on its item columns and its rows of the item-width out-projections,
    against the same batch on one rank of the port: the losses within 1e-6,
    each denoiser's gradient within 1e-4 of its magnitude plus 1e-5 of its
    tensor's largest (a bias in front of a batch norm and MVDiff's time
    embedding bias, zero but for rounding, within 1e-5 of its weight's
    largest), and every parameter after the step within
    ``test_model_axis_batch_matches_one_rank``'s 1e-6 / 1e-7 (DiffMM's
    every element; GenRecV1's and MVDiff's as ``_step_sensitive`` says)."""
    out, cases = world
    got = out[f"phase1_{name}"]
    ref = dryrun.phase1_batch(name, PHASE1[name], CPU, case=cases["phase1_DiffMM"][0] if name == "DiffMM" else None)
    assert got["split"] == sorted(SPLIT[name]) and ref["split"] == []
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-6)
    assert got["grads"].keys() == ref["grads"].keys() and got["grads"]
    for k, r in ref["grads"].items():
        if k.endswith(("lin.bias", "emb.bias")) and name == "MVDiff":
            weight = np.abs(ref["grads"][k[: -len("bias")] + "weight"]).max()
            assert np.abs(got["grads"][k]).max() <= 1e-5 * weight, k
            continue
        np.testing.assert_allclose(got["grads"][k], r, rtol=1e-4, atol=1e-5 * np.abs(r).max(), err_msg=k)
    assert got["params"].keys() == ref["params"].keys()
    lr = float(TConfig(name, "tiny", dict(PHASE1[name]))["learning_rate"])
    excused = total = 0
    for k, r in ref["params"].items():
        a = got["params"][k]
        assert a.shape == r.shape, k
        held = np.ones(r.shape, bool) if name == "DiffMM" else ~_step_sensitive(name, k, r.shape, ref["grads"], lr)
        np.testing.assert_allclose(a[held], r[held], rtol=1e-6, atol=1e-7, err_msg=k)
        # a first Adam step moves an element by less than lr
        assert (np.abs(a - r)[~held] < 2 * lr).all(), k
        excused, total = excused + (~held).sum(), total + r.size
    # the rule excuses 2.2% of GenRecV1's elements, 0.49% of MVDiff's, none of DiffMM's
    assert excused <= 0.03 * total, (excused, total)


# the share of a gradient's largest by which the split's in-projection
# rounds apart from one rank's
SPLIT_ROUNDING = 1e-6


def _step_sensitive(name, k, shape, grads, lr, eps=1e-8):
    """The elements of parameter ``k`` whose first Adam step, lr·g / (|g| +
    eps), the split's rounding can move past the 1e-7 bound: a gradient
    that rounds apart by δ moves the step by lr·eps·δ / (|g| + eps)², with δ
    ``SPLIT_ROUNDING`` of the tensor's largest gradient (of its weight's for
    MVDiff's biases in front of a batch norm and its time embedding's bias,
    zero but for rounding). A parameter that the batch does not step has
    none."""
    if k not in grads:
        return np.zeros(shape, bool)
    g = np.abs(grads[k])
    scale = g.max()
    if name == "MVDiff" and k.endswith(("lin.bias", "emb.bias")):
        scale = np.abs(grads[k[: -len("bias")] + "weight"]).max()
    return lr * eps * SPLIT_ROUNDING * scale / (g + eps) ** 2 > 1e-7


def test_model_axis_diffmm_phase1_matches_jax(world):
    """DiffMM's phase-1 batch on ``{data: 1, model: 2}`` from the JAX
    parameters and draws: the losses and every denoiser gradient against
    ``jax.grad`` of the JAX loss at the global batch, within the bounds of
    ``test_diffusion_epoch_matches_jax`` and the gradient parity tests."""
    out, cases = world
    got = out["phase1_DiffMM"]
    case, ref_losses, ref_grads = cases["phase1_DiffMM"]
    np.testing.assert_allclose(got["losses"], ref_losses, rtol=1e-4)
    config = TConfig("DiffMM", "tiny", dict(PHASE1["DiffMM"]))
    tm = t_get_model("DiffMM")(config, t_train(TDataset(config).split()[0], CPU))
    names = dict(zip(params_by_jax_name(tm), dict(tm.named_parameters())))
    denoisers = {j: p for j, p in names.items() if j.startswith("denoise_")}
    assert denoisers.keys() == ref_grads.keys() and len(denoisers) == 12
    for jname, pname in denoisers.items():
        r = ref_grads[jname]
        np.testing.assert_allclose(got["grads"][pname], r, rtol=1e-4, atol=1e-5 * np.abs(r).max(), err_msg=jname)


def test_mesh_regeneration_matches_one_rank(world):
    """DiffMM's phase 1 and regeneration on the 2 × 2 mesh (the item split
    over ``model``: K3 on each rank's columns, merged; the user chunks dealt
    over ``data``) give one rank's generated graphs."""
    got = world[0]["regen_DiffMM"]
    ref = dryrun.regeneration("DiffMM", dryrun.DRYRUN, CPU)
    assert got.keys() == ref.keys() == {"image_ui", "text_ui"}
    for k in ref:
        for a, b in zip(got[k], ref[k]):
            np.testing.assert_array_equal(a, b, err_msg=k)
