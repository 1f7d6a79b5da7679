"""Four places where the port once raised where the JAX package answers, on
the CPU, each held against the JAX package.

- Any k: ``fused_grouped_topk`` at k = 65 and 100 against the JAX function
  (Pallas in interpret mode); K3's mirrored selection
  (``grouped_topk_selection_plain``, which for k > 64 follows the kernel's
  radix path) at k = 65, 256, 257 and n against ``lax.top_k``; K4's route
  rule for a k wider than its shared memory holds.
- An embedding wider than the fused kernels' widest (192 > 128) under
  ``eval_dtype: bfloat16``: ``Trainer.eval_topk`` takes the plane route
  (bfloat16 scores, K3 with the packed mask), pinned here by the calls it
  makes, and its lists equal the JAX trainer's.
- A graph that is not row-sorted: ``spmm`` and ``spmm_t`` through its kept
  row-sorted view, values and the gradients in x and in vals against the
  JAX ``spmm`` / ``spmm_t`` of the same edges with ``sorted=False`` and
  ``jax.grad``, to 1e-5 relative (float32 summation order).
- A model with ``scores`` alone: a toy model defined in both packages here,
  evaluated by both trainers chunk by chunk; lists and metrics equal.

The inputs come from numpy with a seed and go to both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genmmrec_tpu.config import Config as JConfig
from genmmrec_tpu.data.arrays import build_eval_data as j_eval
from genmmrec_tpu.data.arrays import build_train_data as j_train
from genmmrec_tpu.data.dataset import RecDataset as JDataset
from genmmrec_tpu.engine.trainer import Trainer as JTrainer
from genmmrec_tpu.models import get_model as j_get_model
from genmmrec_tpu.models.base import RecModel as JRecModel
from genmmrec_tpu.ops import graph as jgraph
from genmmrec_tpu.ops.fused_topk import TILE_N, pack_planar_mask
from genmmrec_tpu.ops.fused_topk import fused_grouped_topk as j_fused
from genmmrec_tpu_torch.config import Config as TConfig
from genmmrec_tpu_torch.data.arrays import build_eval_data as t_eval
from genmmrec_tpu_torch.data.arrays import build_train_data as t_train
from genmmrec_tpu_torch.data.dataset import RecDataset as TDataset
from genmmrec_tpu_torch.engine import trainer as trainer_module
from genmmrec_tpu_torch.engine.evaluator import group_masks
from genmmrec_tpu_torch.engine.trainer import Trainer as TTrainer
from genmmrec_tpu_torch.interop import from_jax_params
from genmmrec_tpu_torch.models import get_model as t_get_model
from genmmrec_tpu_torch.models.base import RecModel as TRecModel
from genmmrec_tpu_torch.ops import fused_topk as F
from genmmrec_tpu_torch.ops import graph as tgraph
from genmmrec_tpu_torch.ops import topk as T

CPU = torch.device("cpu")
SLICE = {
    "synthetic_n_users": 300,
    "synthetic_n_items": 1600,
    "synthetic_n_inters": 6000,
    "save_recommended_topk": False,
    "mesh_shape": {"data": 1, "model": 1},
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _plain_pack(dense):
    """(b, n) bool → the port's mask: little-endian bits over whole groups of
    128 columns, the pad columns set."""
    b, n = dense.shape
    full = np.ones((b, F.n_groups_for(n) * F.GROUP), bool)
    full[:, :n] = dense
    return np.packbits(full, axis=1, bitorder="little")


def _ordinal(x):
    """bfloat16-valued float32 array → integers in value order, one apart
    for neighbouring bfloat16 values."""
    bits = (np.asarray(x, np.float32).view(np.uint32) >> 16).astype(np.int64)
    return np.where(bits & 0x8000, -(bits & 0x7FFF), bits)


def _bf16_plane(u, t):
    bf = lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
    return bf(bf(u) @ bf(t).T)


# ---------------------------------------------------------------- any k


@pytest.mark.parametrize("kind", ["integer", "gaussian"])
@pytest.mark.parametrize("k", [65, 100])
def test_fused_grouped_topk_past_64_matches_jax(k, kind):
    """k past the old cap of 64, over 8,692 items (68 groups of 128: at k =
    100 every group is a candidate). Integer operands: values equal the JAX
    function's and indices wherever a row's values are distinct (it orders
    ties by group rank, the port by index); Gaussian: one bfloat16 ulp, and
    the lists differ only across one-ulp neighbours."""
    b, d, n = 5, 64, TILE_N + 500
    rng = np.random.default_rng(k)
    if kind == "integer":
        u, t = rng.integers(-2, 3, (b, d)).astype(np.float32), rng.integers(-2, 3, (n, d)).astype(np.float32)
    else:
        u, t = rng.standard_normal((b, d), np.float32), rng.standard_normal((n, d), np.float32)
    dense = rng.random((b, n)) < 0.05
    jv, ji = j_fused(jnp.asarray(u), jnp.asarray(t), k, jnp.asarray(pack_planar_mask(dense)), interpret=True)
    jv, ji = np.asarray(jv, np.float32), np.asarray(ji)
    tv, ti = F.fused_grouped_topk(_t(u), _t(t), k, _t(_plain_pack(dense)))
    assert tv.shape == ti.shape == (b, k) and tv.dtype == torch.bfloat16
    tv, ti = tv.float().numpy(), ti.numpy()
    rows = np.arange(b)[:, None]
    assert (ti < n).all() and not dense[rows, ti].any() and all(len(set(r)) == k for r in ti)
    plane = np.where(dense, -np.inf, _bf16_plane(u, t))
    order = np.argsort(-plane, axis=1, kind="stable")[:, :k]
    if kind == "integer":
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(ti, order)
        distinct = np.array([len(set(r)) == k for r in tv])
        np.testing.assert_array_equal(ti[distinct], ji[distinct])
    else:
        assert np.abs(_ordinal(tv) - _ordinal(jv)).max() <= 1
        diff = ti != ji
        near = np.abs(_ordinal(plane[rows, ti]) - _ordinal(plane[rows, ji])) <= 1
        assert near[diff].all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("k", [65, 256, 257, "n"])
def test_selection_past_64_matches_lax_top_k(k, masked, dtype):
    """K3's selection as the kernel's radix path makes it, at k = 65, 256,
    257 and the whole row, against ``lax.top_k`` of the same masked row:
    indices equal, the many bfloat16 ties and the masked tail included."""
    b, n = 6, 3000
    k = n if k == "n" else k
    rng = np.random.default_rng(k + masked)
    s = torch.from_numpy(rng.standard_normal((b, n)).astype(np.float32)).to(dtype)
    s[0] = 0.5  # a constant row
    s[1, 100:] = float("-inf")  # fewer finite scores than k
    dense = rng.random((b, n)) < 0.3 if masked else np.zeros((b, n), bool)
    packed = _t(np.packbits(dense, axis=1, bitorder="little")) if masked else None
    v, i = T.grouped_topk_selection_plain(s, k, packed)
    v_ref, i_ref = T.grouped_topk_plain(s, k, packed)
    _, j_idx = jax.lax.top_k(np.where(dense, -np.inf, s.float().numpy()), k)
    np.testing.assert_array_equal(i.numpy(), np.asarray(j_idx))
    assert torch.equal(i, i_ref) and v.dtype == dtype
    fin = torch.isfinite(v_ref.float())
    assert torch.equal(v[fin], v_ref[fin]) and torch.equal(torch.isfinite(v.float()), fin)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_unordered_wide_rows_are_put_in_the_contracts_order(dtype):
    """Past K3's 512-word buffer the kernel writes a row's k columns in no
    order and ``order_rows`` orders them: shuffled top-1,000 rows, ties, a
    NaN, both zeros and a masked tail among them, come out as the plain
    top-k's."""
    rng = np.random.default_rng(1)
    b, n, k = 4, 3000, 1000
    s = torch.from_numpy(np.round(rng.standard_normal((b, n)) * 4).astype(np.float32) / 4).to(dtype)
    s[0, 7], s[1, 5:9], s[2, :2200] = float("nan"), -0.0, float("-inf")
    v_ref, i_ref = T.grouped_topk_plain(s, k)
    order = torch.from_numpy(np.stack([rng.permutation(k) for _ in range(b)]))
    v, i = T.order_rows(v_ref.gather(1, order), i_ref.gather(1, order))
    assert torch.equal(i, i_ref)
    assert torch.equal(v.isnan(), v_ref.isnan()) and torch.equal(v[~v.isnan()], v_ref[~v_ref.isnan()])


def test_k4_takes_what_its_shared_memory_holds_and_k3_the_rest(monkeypatch):
    """The switched route's rule: K4 for up to MAX_EXTRACT_GROUPS groups,
    K3 on the whole row past that; ``candidate_extract`` refuses more."""
    n = 2 * T.MAX_EXTRACT_GROUPS * T.GROUP + T.GROUP * 5
    monkeypatch.setenv("GENMMREC_PALLAS_TOPK", "1")
    assert T.takes_two_stage(n, 100) and T.takes_two_stage(n, T.MAX_EXTRACT_GROUPS)
    assert not T.takes_two_stage(n, T.MAX_EXTRACT_GROUPS + 1)
    assert not T.takes_two_stage(T.GROUP * 200, 100)  # the narrow-row rule
    monkeypatch.delenv("GENMMREC_PALLAS_TOPK")
    assert not T.takes_two_stage(n, 100)
    s = torch.zeros(2, 3 * T.GROUP)
    for kp, ok in ((T.MAX_EXTRACT_GROUPS, True), (T.MAX_EXTRACT_GROUPS + 1, False)):
        gidx = torch.zeros(2, kp, dtype=torch.int32)
        if ok:
            assert T.candidate_extract(s, gidx, 100)[1].shape == (2, 100)
        else:
            with pytest.raises(ValueError, match="groups a row"):
                T.candidate_extract(s, gidx, 100)


# ---------------------------------------------------------------- width 192


def _lightgcn_pair(width, eval_dtype):
    over = {**SLICE, "embedding_size": width, "eval_dtype": eval_dtype}
    jc, tc = JConfig("LightGCN", "tiny", dict(over)), TConfig("LightGCN", "tiny", dict(over))
    j_splits, t_splits = JDataset(jc).split(), TDataset(tc).split()
    jm = j_get_model("LightGCN")(jc, j_train(j_splits[0]))
    tm = t_get_model("LightGCN")(tc, t_train(t_splits[0], CPU))
    params = jm.init_params(jax.random.PRNGKey(0))
    from_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    pop, warm = group_masks(t_splits[0], CPU)
    jc["pop_mask"], jc["warm_mask"] = jnp.asarray(pop.numpy()), jnp.asarray(warm.numpy())
    tc["pop_mask"], tc["warm_mask"] = pop, warm
    jtr, ttr = JTrainer(jc, jm), TTrainer(tc, tm)
    jtr._state = {}
    bs = int(jc["eval_batch_size"])
    jed = j_eval(j_splits[1], j_splits[0], bs)
    ted = t_eval(t_splits[1], t_splits[0], bs, CPU)
    return jtr, ttr, params, jed, ted


def _jax_eval_topk(trainer, params, ed):
    if trainer._eval_fn is None:
        trainer._eval_fn = trainer._build_eval_fn()
    n_chunks = ed.users.shape[0] // trainer.eval_batch_size
    dense = trainer._dense_mask(ed, planar=trainer._fused_eval)
    users, mask = trainer._shard_eval_inputs(ed.users, dense)
    return np.asarray(trainer._eval_fn(params, trainer._state, users, mask, n_chunks, dense_mask=True))


def test_bf16_evaluation_wider_than_the_fused_kernels_takes_the_plane_route(monkeypatch):
    """LightGCN at embedding width 192 with ``eval_dtype: bfloat16``: the
    trainer never calls the fused top-k and hands K3 bfloat16 scores with
    the packed mask, on the CPU as on the card; the lists equal the JAX
    trainer's and the metrics too."""
    assert 192 > F.KERNEL_WIDTHS[-1]
    jtr, ttr, params, jed, ted = _lightgcn_pair(192, "bfloat16")

    def no_fused(*args, **kwargs):
        raise AssertionError("the fused route was taken for an embedding wider than its kernels")

    calls = []

    def recorded(scores, k, packed_mask=None):
        calls.append((scores.dtype, packed_mask is not None))
        return T.grouped_topk(scores, k, packed_mask)

    monkeypatch.setattr(trainer_module, "fused_grouped_topk", no_fused)
    monkeypatch.setattr(trainer_module, "grouped_topk", recorded)
    t_top = ttr.eval_topk(ted).numpy()
    assert calls and set(calls) == {(torch.bfloat16, True)}
    j_top = _jax_eval_topk(jtr, params, jed)
    # the two packages round a bfloat16 score at other places (one ulp, about
    # 1 in 10^4 here): the lists are equal but where the two items' scores in
    # the port's plane are one ulp apart
    with torch.no_grad():
        plane = ttr.model.scores_cached(ttr.state, ted.users, ttr.model.eval_artifacts(ttr.state)).float().numpy()
    rows = np.arange(len(plane))[:, None]
    apart = np.abs(_ordinal(plane[rows, t_top]) - _ordinal(plane[rows, j_top]))
    assert apart[t_top != j_top].max(initial=0) <= 1 and (t_top != j_top).mean() < 1e-3
    j_res, t_res = jtr.evaluate(params, jed), ttr.evaluate(ted)
    assert t_res.keys() == j_res.keys()
    for k in j_res:
        assert abs(t_res[k] - j_res[k]) <= 5e-3, (k, t_res[k], j_res[k])


def test_bf16_evaluation_at_the_kernels_width_stays_fused(monkeypatch):
    """The width rule leaves the kernels' widths on the fused route."""
    _, ttr, _, _, ted = _lightgcn_pair(128, "bfloat16")
    fused = []

    def recorded(*args, **kwargs):
        fused.append(1)
        return F.fused_grouped_topk(*args, **kwargs)

    monkeypatch.setattr(trainer_module, "fused_grouped_topk", recorded)
    ttr.eval_topk(ted)
    assert len(fused) == ted.users.shape[0] // ttr.eval_batch_size


# ---------------------------------------------------------------- unsorted graphs


def _shuffled_graphs(seed=3):
    rng = np.random.default_rng(seed)
    nu, ni = 120, 90
    users, items = rng.integers(0, nu, 900), rng.integers(0, ni, 900)
    jg = jgraph.ui_norm_adj(users, items, nu, ni)
    tg = tgraph.ui_norm_adj(users, items, nu, ni, CPU)
    order = rng.permutation(tg.nnz)
    rows, cols, vals = (np.asarray(a)[order] for a in (jg.rows, jg.cols, jg.vals))
    j_unsorted = jgraph.SparseGraph(jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals), nu, ni, sorted=False)
    t_unsorted = tgraph.SparseGraph(
        rows=_t(rows), cols=_t(cols), vals=_t(vals), row_ptr=torch.zeros(0, dtype=torch.int32),
        n_rows=nu, n_cols=ni, sorted=False,
    )
    return j_unsorted, t_unsorted, rng


@pytest.mark.parametrize("op", ["spmm", "spmm_t"])
def test_unsorted_graph_matches_jax_through_its_row_sorted_view(op, monkeypatch):
    jg, tg, rng = _shuffled_graphs()
    n_in, n_out = (tg.n_cols, tg.n_rows) if op == "spmm" else (tg.n_rows, tg.n_cols)
    x = rng.standard_normal((n_in, 16)).astype(np.float32)
    w = rng.standard_normal((n_out, 16)).astype(np.float32)
    j_op, t_op = getattr(jgraph, op), getattr(tgraph, op)

    def j_loss(vals, xx):
        return (j_op(dataclasses.replace(jg, vals=vals), xx) * w).sum()

    ref, (r_vals, r_x) = jax.value_and_grad(j_loss, argnums=(0, 1))(jg.vals, jnp.asarray(x))
    # the route: the row-sorted kernels' entry points, never a scatter
    products = []
    for name in ("spmm_sorted", "spmm_symmetric"):
        real = getattr(tgraph, name)
        monkeypatch.setattr(tgraph, name, lambda *a, _real=real, _name=name, **k: products.append(_name) or _real(*a, **k))
    vals = tg.vals.clone().requires_grad_()
    tx = _t(x).requires_grad_()
    g = dataclasses.replace(tg, vals=vals)  # shares the kept view's structure
    out = t_op(g, tx)
    total = (out * _t(w)).sum()
    total.backward()
    assert products == ["spmm_sorted"]
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_op(jg, jnp.asarray(x))), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(total.item(), float(ref), rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(r_x), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(vals.grad.numpy(), np.asarray(r_vals), rtol=1e-5, atol=1e-6)
    # the view's order is computed once and kept with the graph and its copies
    perm = tg._row_sort["perm"]
    view = tg.row_sorted()
    assert view.sorted and bool((view.rows[1:] >= view.rows[:-1]).all()) and tg._row_sort["perm"] is perm
    assert torch.equal(view.rows, tg.rows[perm]) and bool((perm[1:][view.rows[1:] == view.rows[:-1]]
                                                           > perm[:-1][view.rows[1:] == view.rows[:-1]]).all())
    assert view.long_rows is tg._row_sort["long_rows"] and tg.row_sorted().row_ptr is view.row_ptr


def test_a_sorted_graph_is_its_own_view():
    users, items = np.arange(10), np.arange(10) % 4
    g = tgraph.ui_norm_adj(users, items, 10, 4, CPU)
    assert g.row_sorted() is g and not g._row_sort


# ---------------------------------------------------------------- scores alone


class JScoresOnly(JRecModel):
    """Scores that are no ``u @ iᵀ`` of cached embeddings: a toy model with
    ``scores`` alone."""

    is_multimodal = False

    def init_params(self, key):
        ku, ki = jax.random.split(key)
        return {"u": jax.random.normal(ku, (self.n_users, 16)), "i": jax.random.normal(ki, (self.n_items, 16))}

    def scores(self, params, state, users):
        return jnp.tanh(params["u"][users]) @ params["i"].T


class TScoresOnly(TRecModel):
    is_multimodal = False

    def __init__(self, config, data, params):
        super().__init__(config, data)
        self.u = torch.nn.Parameter(_t(params["u"]))
        self.i = torch.nn.Parameter(_t(params["i"]))

    def scores(self, state, users):
        return torch.tanh(self.u[users]) @ self.i.T


def test_a_model_with_scores_alone_evaluates_as_the_jax_trainer():
    over = {**SLICE, "topk": [5, 10, 20, 50]}
    jc, tc = JConfig("BPR", "tiny", dict(over)), TConfig("BPR", "tiny", dict(over))
    j_splits, t_splits = JDataset(jc).split(), TDataset(tc).split()
    jm = JScoresOnly(jc, j_train(j_splits[0]))
    params = jax.tree_util.tree_map(np.asarray, jm.init_params(jax.random.PRNGKey(4)))
    tm = TScoresOnly(tc, t_train(t_splits[0], CPU), params)
    pop, warm = group_masks(t_splits[0], CPU)
    jc["pop_mask"], jc["warm_mask"] = jnp.asarray(pop.numpy()), jnp.asarray(warm.numpy())
    tc["pop_mask"], tc["warm_mask"] = pop, warm
    jtr, ttr = JTrainer(jc, jm), TTrainer(tc, tm)
    jtr._state = {}
    bs = int(jc["eval_batch_size"])
    for j_split, t_split, is_test in ((j_splits[1], t_splits[1], False), (j_splits[2], t_splits[2], True)):
        jed, ted = j_eval(j_split, j_splits[0], bs), t_eval(t_split, t_splits[0], bs, CPU)
        with torch.no_grad():
            t_top = ttr.eval_topk(ted).numpy()
        j_top = _jax_eval_topk(jtr, params, jed)
        # float32 scores summed in another order: lists equal but across near-ties
        scores = tm.scores({}, ted.users).detach().numpy()
        rows = np.arange(len(scores))[:, None]
        gap = np.abs(scores[rows, t_top] - scores[rows, j_top])
        assert gap[t_top != j_top].max(initial=0.0) <= 1e-5 and (t_top != j_top).mean() < 0.01
        j_res, t_res = jtr.evaluate(params, jed, is_test=is_test), ttr.evaluate(ted, is_test=is_test)
        assert t_res.keys() == j_res.keys()
        for k in j_res:
            assert abs(t_res[k] - j_res[k]) <= 1e-4 + 1e-9, (k, t_res[k], j_res[k])


def test_a_model_with_neither_scores_nor_embeddings_names_both():
    tc = TConfig("BPR", "tiny", dict(SLICE))
    td = t_train(TDataset(tc).split()[0], CPU)

    class Nothing(TRecModel):
        is_multimodal = False

    tr = TDataset(tc).split()
    tc["pop_mask"], tc["warm_mask"] = group_masks(tr[0], CPU)
    trainer = TTrainer(tc, Nothing(tc, td))
    with pytest.raises(NotImplementedError, match="full_embeddings.*scores"):
        trainer.eval_topk(t_eval(tr[1], tr[0], 64, CPU))
