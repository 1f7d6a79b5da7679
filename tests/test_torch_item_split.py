"""The model axis's item split of the diffusion denoisers
(``genmmrec_tpu_torch.parallel.mesh.ItemCols``) in one process, on the CPU.

The ranks of a ``{data: 1, model: S}`` mesh run as S threads of this
process, whose model-axis sums and gathers go through ``ThreadExchange``
(the mesh's ``exchange``), so that the port's own code runs on each shard:
``Denoise`` against its whole forward and the JAX ``apply_dnn``,
``ModalDenoise`` and MVDiff's sparsity denoiser against their whole
forwards, at widths that divide by S and widths that do not; the forward
and every gradient of ``DiffMM.diffusion_losses`` on shards against
``jax.grad`` of the JAX model at the global batch; GenRecV1's loss and
``generate`` on shards against one rank; a DiffMM fit on the split with
its checkpoint (whole tensors) and a resume from it; and, with no mesh and
on ``model = 1``, phase 1 and the regeneration bit-equal to each other and
off the split. The tables held at rest over the model axis
(``parallel.mesh.hold_table_rows``) on the same threads: each rank's rows
of LightGCN and DiffMM against the JAX ``shard_model_params`` shards of
its model index and one training batch against one rank; a BPR fit's
layout, its checkpoint (whole tables) loaded back, and the JAX trainer's
log line of the placement, or its warning.
"""

import copy
import logging
import threading

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
from genmmrec_tpu.models.diffusion.dnn import apply_dnn, init_dnn
from genmmrec_tpu.models.modal_denoise import init_modal_denoise
from genmmrec_tpu.parallel import mesh as jmesh
from genmmrec_tpu_torch.config import Config as TConfig
from genmmrec_tpu_torch.data.arrays import build_train_data as t_train
from genmmrec_tpu_torch.data.arrays import interaction_vectors
from genmmrec_tpu_torch.data.dataset import RecDataset as TDataset
from genmmrec_tpu_torch.engine.checkpoint import load_checkpoint
from genmmrec_tpu_torch.engine.trainer import get_trainer
from genmmrec_tpu_torch.interop import from_jax_params, jax_tree_by_name, params_by_jax_name
from genmmrec_tpu_torch.models import get_model as t_get_model
from genmmrec_tpu_torch.models.diffusion.dnn import Denoise
from genmmrec_tpu_torch.models.modal_denoise import ModalDenoise
from genmmrec_tpu_torch.parallel import launch
from genmmrec_tpu_torch.parallel import mesh as pm
from test_torch_rf_hosts import _one_torch_thread  # noqa: F401 (autouse: one torch thread a test worker)
from test_torch_train import _jax_diffusion_draws, _np_tree

CPU = torch.device("cpu")
# the overrides of the trainer-level cases: one batch of the 64 tiny users
ONE_BATCH = {"save_recommended_topk": False, "epochs": 1, "train_batch_size": 64, "eval_batch_size": 64,
             "topk": [5, 10], "metrics": ["Recall", "NDCG"], "valid_metric": "Recall@10",
             "hyper_parameters": ["seed"]}


class ThreadExchange:
    """The model axis of a ``{data: 1, model: S}`` mesh whose ranks are S
    threads of this process: each collective puts every rank's tensor in
    its slot, waits for all, and reads the slots in rank order."""

    def __init__(self, S: int):
        self.slots = [None] * S
        self.barrier = threading.Barrier(S)

    def _swap(self, t, mesh, axis):
        assert axis == pm.MODEL_AXIS and mesh.data == 1
        self.slots[mesh.model_rank] = t.detach().clone()
        self.barrier.wait()
        parts = list(self.slots)
        self.barrier.wait()
        return parts

    def all_reduce(self, t, mesh, axis):
        parts = self._swap(t, mesh, axis)
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return t.copy_(total)

    def all_gather(self, t, mesh, axis):
        return torch.cat(self._swap(t, mesh, axis))


def on_shards(S: int, fn) -> list:
    """``fn(mesh)`` on each rank of a ``{data: 1, model: S}`` mesh of
    threads → the ranks' results in rank order; a rank's error is raised."""
    ex = ThreadExchange(S)
    out, errors = [None] * S, []

    def rank(r):
        try:
            out[r] = fn(pm.Mesh(1, S, r, exchange=ex))
        except BaseException as e:  # noqa: BLE001 (handed to the caller)
            errors.append(e)
            ex.barrier.abort()

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(S)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def _grads(module) -> dict:
    """Every parameter's gradient of ``module``, whole (an item-split one
    gathered from the ranks)."""
    out = {}
    for k, p in module.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        held = getattr(p, "held_rows", None)
        out[k] = (g if held is None else held.gather(g, 0)).numpy()
    return out


def _assert_grads(got: dict, ref: dict, zero: dict = None) -> None:
    """Every gradient within 1e-4 of its magnitude plus 1e-5 of its tensor's
    largest; one of ``zero`` (name -> its weight's name), zero but for
    rounding, within 1e-5 of its weight's largest."""
    zero = zero or {}
    assert got.keys() == ref.keys()
    for k, r in ref.items():
        if k in zero:
            assert np.abs(got[k]).max() <= 1e-5 * np.abs(ref[zero[k]]).max(), k
            continue
        np.testing.assert_allclose(got[k], r, rtol=1e-4, atol=1e-5 * np.abs(r).max(), err_msg=k)


def test_item_bounds_take_even_rows_where_the_width_divides():
    """One split for the activations, the out-projections and the top-k: the
    rows ``shard_model_params`` takes where the width divides, else
    ``shard_bounds``; the masked evaluation's shards stay byte-aligned."""
    assert pm.item_bounds(7050, 2) == [(0, 3525), (3525, 7050)]
    assert pm.item_bounds(7050, 3) == [(0, 2350), (2350, 4700), (4700, 7050)]
    assert pm.item_bounds(63001, 2) == pm.shard_bounds(63001, 2) == [(0, 31504), (31504, 63001)]
    assert pm.item_bounds(7050, 4) == pm.shard_bounds(7050, 4)
    assert pm.item_sharding(None, 7050) is None and pm.item_sharding(pm.Mesh(2, 1), 7050) is None
    cols = pm.item_sharding(pm.Mesh(1, 2, 1), 7050)
    assert (cols.lo, cols.hi, cols.width) == (3525, 7050, 3525)
    with pytest.raises(ValueError, match="byte"):
        pm.sharded_topk(torch.zeros(2, 10), 1, pm.Mesh(1, 2, 1), torch.zeros(2, 2, dtype=torch.uint8),
                        bounds=pm.item_bounds(10, 2))


@pytest.mark.parametrize("n,S", [(48, 2), (37, 4), (7050, 4), (63001, 2)])
def test_interaction_vectors_of_a_column_range(n, S):
    rng = np.random.default_rng(n)
    hist = np.full((6, 9), n)
    for u in range(6):
        k = rng.integers(0, 9)
        hist[u, :k] = rng.choice(n, k, replace=False)
    td = type("TD", (), {"hist": torch.as_tensor(hist), "n_items": n})()
    users = torch.tensor([0, 3, 5, 1])
    whole = interaction_vectors(td, users)
    for lo, hi in pm.item_bounds(n, S):
        part = interaction_vectors(td, users, pm.ItemCols(pm.Mesh(1, S, pm.item_bounds(n, S).index((lo, hi))), n))
        assert torch.equal(part, whole[:, lo:hi])


# each model's draw functions: (model, overrides) -> [generator -> draws]
DRAW_FNS = {
    "DiffMM": lambda m, g: {"phase1": m.diffusion_draws(8, g), "chain": m.sample_noise((8, m.n_items), g)},
    "GenRecV1": lambda m, g: {"phase1": m.diffusion_draws(8, g), "generate": m.generate_draws(8, g)},
    "MVDiff": lambda m, g: m.sparsity_draws(g, 8),
}


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


@pytest.mark.parametrize("name", sorted(DRAW_FNS))
def test_draw_functions_give_this_ranks_columns(name):
    """On the item split each model's draw functions make their draws whole
    from the generator, in one rank's order, and give this rank's columns
    of every plane over the items (``ItemCols.planes``); the timesteps and
    the hidden layers' masks stay whole. Off the split they are whole."""
    config = TConfig(name, "tiny", {**ONE_BATCH, "num_layers": 2} if name == "GenRecV1" else dict(ONE_BATCH))
    model = t_get_model(name)(config, t_train(TDataset(config).split()[0], CPU))
    n = model.n_items
    whole = _leaves(DRAW_FNS[name](model, torch.Generator().manual_seed(3)))
    planes = [t.dim() >= 2 and t.shape[-1] == n for t in whole]
    assert sum(planes) >= 2 and not all(planes)
    for r in range(2):
        m = copy.deepcopy(model)
        cols = pm.ItemCols(pm.Mesh(1, 2, r), n)
        m.split_items(cols)
        got = _leaves(DRAW_FNS[name](m, torch.Generator().manual_seed(3)))
        assert len(got) == len(whole)
        for a, b, plane in zip(got, whole, planes):
            assert torch.equal(a, b[..., cols.lo : cols.hi] if plane else b)
        assert all(torch.equal(a, b) for a, b in zip(_leaves(cols.planes(got)), got))


def test_model_axis_collectives_on_threads():
    """``ItemCols.sum`` passes the cotangent on unchanged and ``enter`` sums
    it over the ranks, so that a replicated tensor's gradient is the whole
    one on every rank (not S times it); ``columns`` gives each rank the
    whole gradient of a weight read by columns; ``gather``, ``holds`` and
    ``topk`` give the whole tensor, its ids' columns and the exact top-k
    (ties to the lower id)."""
    n, S = 11, 3
    w0, v0 = torch.randn(4, n, dtype=torch.float64), torch.randn(4, n, dtype=torch.float64)
    x0 = torch.randn(5, n, dtype=torch.float64)
    h0 = torch.randn(5, 4, dtype=torch.float64)
    scores = torch.tensor(np.random.default_rng(0).integers(0, 3, (5, n)), dtype=torch.float32)

    def rank(mesh):
        cols = pm.ItemCols(mesh, n)
        w, h = w0.clone().requires_grad_(), h0.clone().requires_grad_()
        # an in-projection: a partial product over the columns, summed (replicated)
        y = cols.sum(cols.local(x0) @ cols.columns(w).T)
        # an out-projection: the replicated h into this rank's columns
        out = cols.enter(h * y) @ cols.local(v0)
        cols.sum((out * cols.local(x0)).sum()).backward()
        vals, ids = cols.topk(cols.local(scores).contiguous(), 4)
        return w.grad, h.grad, y.detach(), cols.gather(cols.local(x0)), cols.holds(ids), ids, vals

    ref_w, ref_h = w0.clone().requires_grad_(), h0.clone().requires_grad_()
    ref_y = x0 @ ref_w.T
    (((ref_h * ref_y) @ v0) * x0).sum().backward()
    v_ref, i_ref = jax.lax.top_k(jnp.asarray(scores.numpy()), 4)
    for r, (gw, gh, y, whole, held, ids, vals) in enumerate(on_shards(S, rank)):
        torch.testing.assert_close(gw, ref_w.grad)
        torch.testing.assert_close(gh, ref_h.grad)
        torch.testing.assert_close(y, ref_y.detach())
        assert torch.equal(whole, x0)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(i_ref))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(v_ref))
        lo, hi = pm.item_bounds(n, S)[r]
        chosen = torch.zeros(5, n, dtype=torch.bool).scatter_(1, ids, True)
        assert torch.equal(held, chosen[:, lo:hi])


@pytest.mark.parametrize("n,S,norm", [(48, 2, False), (37, 4, True), (7050, 2, True), (7050, 4, False),
                                      (63001, 2, False)])
def test_denoise_on_shards_matches_whole_and_apply_dnn(n, S, norm):
    """``Denoise`` on S column shards (the in-projection summed over the
    axis, the out-projection's rows held by each rank): the gathered output
    within 1e-5 of the whole forward and of the JAX ``apply_dnn`` with the
    same keep mask, and every gradient of a loss over the output equal to
    the whole's, the same on every rank."""
    B, hidden = (4, 32) if n > 10_000 else (8, 64)
    params = init_dnn(jax.random.PRNGKey(n), [n, hidden], [hidden, n], 10)
    whole = from_jax_params(Denoise([n, hidden], [hidden, n], 10, norm), _np_tree(params))
    rng = np.random.default_rng(n)
    x = (rng.random((B, n)) < 0.05).astype(np.float32)
    t = rng.integers(0, 5, B)
    k = jax.random.PRNGKey(7)
    keep = np.asarray(jax.random.bernoulli(k, 0.5, x.shape))
    ref_jax = np.asarray(apply_dnn(params, jnp.asarray(x), jnp.asarray(t), dropout=0.5, key=k, norm=norm))
    target = torch.as_tensor(rng.normal(size=(B, n)).astype(np.float32))
    ref = whole(torch.as_tensor(x), torch.as_tensor(t), dropout=0.5, keep=torch.as_tensor(keep))
    ((ref - target) ** 2).sum().backward()
    ref_grads = _grads(whole)

    def rank(mesh):
        net = copy.deepcopy(whole)
        net.zero_grad(set_to_none=True)
        cols = pm.ItemCols(mesh, n)
        net.split_items(cols)
        out = net(cols.local(torch.as_tensor(x)), torch.as_tensor(t), dropout=0.5,
                  keep=cols.local(torch.as_tensor(keep)))
        assert out.shape == (B, cols.width) and net.out_layers[-1].weight.shape == (cols.width, hidden)
        cols.sum(((out - cols.local(target)) ** 2).sum()).backward()
        return cols.gather(out.detach()), _grads(net)

    for out, grads in on_shards(S, rank):
        np.testing.assert_allclose(out.numpy(), ref.detach().numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out.numpy(), ref_jax, rtol=1e-5, atol=1e-5)
        _assert_grads(grads, ref_grads)


@pytest.mark.parametrize("n,S,layers,d_ff", [(48, 4, 2, 64), (45, 2, 2, 64), (7050, 2, 6, 512)])
def test_modal_denoise_on_shards_matches_whole(n, S, layers, d_ff):
    """GenRecV1's ``ModalDenoise`` (at the published 6 × 512 on baby's
    7,050 items too) on S column shards: ``input_proj`` summed over the
    axis, ``out2``'s rows on each rank; the gathered output within 1e-5 of
    the whole forward, every gradient equal to the whole's."""
    init = jax.jit(init_modal_denoise, static_argnums=(1, 2, 3), static_argnames=("num_layers", "dim_feedforward"))
    params = init(jax.random.PRNGKey(n), n, n, 10, num_layers=layers, dim_feedforward=d_ff)
    whole = ModalDenoise(n, n, 10, num_layers=layers, dim_feedforward=d_ff)
    from_jax_params(whole, _np_tree(params))
    rng = np.random.default_rng(n)
    B = 4
    x = torch.as_tensor((rng.random((B, n)) < 0.05).astype(np.float32))
    t = torch.as_tensor(rng.integers(0, 5, B))
    ref = whole(x, t)
    torch.sigmoid(ref).sum().backward()
    ref_grads = _grads(whole)

    def rank(mesh):
        net = copy.deepcopy(whole)
        net.zero_grad(set_to_none=True)
        cols = pm.ItemCols(mesh, n)
        net.split_items(cols)
        out = net(cols.local(x), t)
        cols.sum(torch.sigmoid(out).sum()).backward()
        return cols.gather(out.detach()), _grads(net)

    for out, grads in on_shards(S, rank):
        np.testing.assert_allclose(out.numpy(), ref.detach().numpy(), rtol=1e-5, atol=1e-5)
        _assert_grads(grads, ref_grads)


@pytest.mark.parametrize("n,S", [(48, 2), (48, 4), (45, 2)])
def test_mvdiff_sparsity_denoiser_on_shards_matches_whole(n, S):
    """MVDiff's sparsity denoiser on S column shards with the training
    dropout (the first ``down`` layer summed over the axis, the last ``up``
    layer and its batch norm on each rank's rows): the output within 1e-5
    of the whole forward, every gradient equal to the whole's (a bias in
    front of a batch norm, zero but for rounding, within 1e-5 of its
    weight's largest)."""
    config = TConfig("MVDiff", "tiny", {"synthetic_n_items": n, "norm": True})
    model = t_get_model("MVDiff")(config, t_train(TDataset(config).split()[0], CPU))
    model.init_params(torch.Generator().manual_seed(0))
    B = 16
    users = torch.arange(B)
    x = interaction_vectors(model.data, users)
    draws = model.sparsity_draws(torch.Generator().manual_seed(1), B)
    ts = draws["ts"]
    ref = model.modal_denoise_apply(model.denoise_image, x, ts, draws["keep"])
    ref.square().sum().backward()
    ref_grads = _grads(model.denoise_image)
    zero = {k: k[: -len("bias")] + "weight" for k in ref_grads if k.endswith("lin.bias") or k == "emb.bias"}

    def rank(mesh):
        m = copy.deepcopy(model)
        m.zero_grad(set_to_none=True)
        cols = pm.ItemCols(mesh, n)
        m.split_items(cols)
        local = cols.planes(draws)
        out = m.modal_denoise_apply(m.denoise_image, cols.local(x), ts, local["keep"])
        assert m.denoise_image["up"][-1].bn.g.shape == (cols.width,)
        cols.sum(out.square().sum()).backward()
        return cols.gather(out.detach()), _grads(m.denoise_image)

    for out, grads in on_shards(S, rank):
        np.testing.assert_allclose(out.numpy(), ref.detach().numpy(), rtol=1e-5, atol=1e-5)
        _assert_grads(grads, ref_grads, zero)


@pytest.fixture(scope="module")
def diffmm_pair():
    """The JAX and port DiffMM on tiny with the same parameters."""
    over = {"save_recommended_topk": False}
    jc, tc = JConfig("DiffMM", "tiny", dict(over)), TConfig("DiffMM", "tiny", dict(over))
    jm = j_get_model("DiffMM")(jc, j_train(JDataset(jc).split()[0]))
    tm = t_get_model("DiffMM")(tc, t_train(TDataset(tc).split()[0], CPU))
    params = jm.init_params(jax.random.PRNGKey(0))
    from_jax_params(tm, _np_tree(params))
    return jm, tm, params


@pytest.mark.parametrize("S", [2, 4])
def test_diffmm_diffusion_losses_on_shards_match_jax_grad(diffmm_pair, S):
    """``DiffMM.diffusion_losses`` on S column shards with the JAX draws
    injected (each rank its columns): the per-user losses and every
    gradient of the image denoiser against ``jax.grad`` of the JAX loss at
    the global batch, within the parity test's bounds."""
    jm, tm, params = diffmm_pair
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
    ref_g = jax_tree_by_name(_np_tree({"denoise_image": grads}))
    as_t = lambda a: torch.as_tensor(np.asarray(a))

    def rank(mesh):
        m = copy.deepcopy(tm)
        m.zero_grad(set_to_none=True)
        cols = pm.ItemCols(mesh, m.n_items)
        m.split_items(cols)
        d, g = m.diffusion_losses(m.denoise_image, cols.local(as_t(x_start)), as_t(i_emb), as_t(feats), ts=as_t(ts),
                                  noise=cols.local(as_t(noise)), keep=cols.local(as_t(keep)))
        (d.sum() + m.e_loss * g.sum()).backward()
        names = dict(zip(dict(m.named_parameters()), params_by_jax_name(m)))
        return d.detach(), g.detach(), {names[f"denoise_image.{k}"]: v for k, v in _grads(m.denoise_image).items()}

    for d, g, got in on_shards(S, rank):
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-4)
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4)
        _assert_grads(got, {k: v for k, v in ref_g.items() if k in got})
        assert len(got) == 6


def test_genrecv1_loss_and_generate_on_shards_match_one_rank():
    """GenRecV1's phase-1 loss and ``generate`` on 2 column shards, the
    draws made whole and sliced: the loss within 1e-6 and every gradient of
    the denoiser equal to one rank's; the blended sample and the
    probabilities equal to one rank's (the top-``gen_topk`` by K3 on each
    rank's columns, merged)."""
    config = TConfig("GenRecV1", "tiny", {**ONE_BATCH, "num_layers": 2})
    model = t_get_model("GenRecV1")(config, t_train(TDataset(config).split()[0], CPU))
    model.init_params(torch.Generator().manual_seed(0))
    users = torch.arange(32)
    x = interaction_vectors(model.data, users)
    with torch.no_grad():
        inputs = (model.item_id_embedding.detach().clone(), model.get_image_feats(), model.get_text_feats())
    draws = model.diffusion_draws(32, torch.Generator().manual_seed(1))
    gen = model.generate_draws(32, torch.Generator().manual_seed(2))
    ref = model.diffusion_losses(x, *inputs, draws=draws)
    ref.backward()
    ref_grads = _grads(model.denoise_image)
    blended, probs = model.generate(x, draws=gen)

    def rank(mesh):
        m = copy.deepcopy(model)
        m.zero_grad(set_to_none=True)
        cols = pm.ItemCols(mesh, m.n_items)
        m.split_items(cols)
        local = cols.planes(draws)
        loss = m.diffusion_losses(cols.local(x), *inputs, draws=local)
        loss.backward()
        b, p = m.generate(cols.local(x), draws=cols.planes(gen))
        return loss.detach(), _grads(m.denoise_image), cols.gather(b), cols.gather(p)

    for loss, grads, b, p in on_shards(2, rank):
        np.testing.assert_allclose(loss.item(), ref.item(), rtol=1e-6)
        _assert_grads(grads, ref_grads)
        assert torch.equal(b, blended)
        torch.testing.assert_close(p, probs, rtol=1e-5, atol=1e-6)


def _phases(name, mesh, overrides=ONE_BATCH):
    """A trainer's start (the model from the seed), its phases over (B,
    n_items) vectors from the prelude's generator (MVDiff: all four) → (the
    phase losses, the parameters whole, the generated graphs' edges, the
    trainer)."""
    config = TConfig(name, "tiny", dict(overrides))
    td = t_train(TDataset(config).split()[0], CPU)
    model = t_get_model(name)(config, td)
    trainer = get_trainer(name)(config, model, mesh=mesh)
    model.init_params(trainer.split("init"))
    trainer.state = model.init_state(trainer.split("state"))
    trainer._build_train_step(td)
    gen = trainer.split("epoch", 0, "prelude")
    if name == "MVDiff":
        trainer.feature_epoch(gen)
        trainer.regenerate_items()
        losses = trainer.sparsity_epoch(gen)
        trainer.regenerate_users(gen)
    else:
        losses = trainer._diffusion_epoch(gen)
        trainer.regenerate(gen)
    graphs = {k: tuple(getattr(g, f) for f in ("rows", "cols", "vals"))
              for k, g in trainer.state.items() if k.endswith("_ui")}
    return losses, model.state_dict(), graphs, trainer


@pytest.mark.parametrize("name", ["DiffMM", "GenRecV1", "MVDiff"])
def test_off_the_split_phases_are_bit_equal(name):
    """With no mesh and on a ``model = 1`` mesh (a one-rank process group)
    the item split stays off and phase 1 and the regeneration are bit-equal:
    the same losses, parameters and graphs; on ``model = 2`` the denoisers'
    item-width leaves are held as each rank's rows."""
    import torch.distributed as dist

    ref = _phases(name, None)
    assert ref[3].model.item_cols is None
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{launch._free_port()}", world_size=1, rank=0)
    try:
        mesh = pm.build_mesh({"mesh_shape": {"data": 1, "model": 1}})
        assert mesh.shape == {"data": 1, "model": 1} and mesh.model_group is not None
        got = _phases(name, mesh)
    finally:
        dist.destroy_process_group()
    assert got[3].model.item_cols is None
    assert torch.equal(got[0], ref[0])
    assert got[1].keys() == ref[1].keys() and all(torch.equal(got[1][k], ref[1][k]) for k in ref[1])
    assert all(torch.equal(a, b) for k in ref[2] for a, b in zip(got[2][k], ref[2][k]))
    split = on_shards(2, lambda mesh: [k for k, p in _phases(name, mesh)[3].model.named_parameters()
                                       if isinstance(getattr(p, "held_rows", None), pm.ItemCols)])
    assert split[0] == split[1] and split[0]
    assert all(k.startswith("denoise_") for k in split[0])


def _fit(name, mesh, over):
    """A fit of ``name`` on tiny with ``over`` (with its checkpoints where
    ``over`` names a ``checkpoint_dir``) → (model, trainer)."""
    from genmmrec_tpu_torch.data.arrays import build_eval_data
    from genmmrec_tpu_torch.engine.evaluator import group_masks

    config = TConfig(name, "tiny", dict(over))
    train, valid, test = TDataset(config).split()
    td = t_train(train, CPU)
    vd, sd = build_eval_data(valid, train, 64, CPU), build_eval_data(test, train, 64, CPU)
    config["pop_mask"], config["warm_mask"] = group_masks(train, CPU)
    model = t_get_model(name)(config, td)
    trainer = get_trainer(name)(config, model, mesh=mesh)
    trainer.fit(td, vd, sd, saved="checkpoint_dir" in over, verbose=False)
    return model, trainer


def test_split_fit_checkpoints_whole_tensors_and_resumes(tmp_path):
    """A DiffMM fit on 2 item shards with checkpoints: the checkpoint holds
    every parameter and every Adam moment whole (the shapes of one rank's),
    and a fit resumed from it on the shards takes each rank's rows and ends
    within the mesh tests' 2e-4 of one rank's resumed fit."""
    over = {**ONE_BATCH, "epochs": 1, "checkpoint_dir": str(tmp_path / "split")}
    fit = lambda mesh, over: {k: v.numpy() for k, v in _fit("DiffMM", mesh, over)[0].state_dict().items()}

    on_shards(2, lambda mesh: fit(mesh, over))
    ck = load_checkpoint(str(tmp_path / "split" / "DiffMM-tiny"))
    ref_over = {**over, "checkpoint_dir": str(tmp_path / "one")}
    fit(None, ref_over)
    ref = load_checkpoint(str(tmp_path / "one" / "DiffMM-tiny"))
    assert ck["params"].keys() == ref["params"].keys()
    for k, v in ref["params"].items():
        assert ck["params"][k].shape == v.shape, k
        np.testing.assert_allclose(ck["params"][k].numpy(), v.numpy(), rtol=2e-4, atol=2e-4, err_msg=k)
    for name in ("denoise_image", "denoise_text"):
        got, want = ck["optimizers"][name]["state"], ref["optimizers"][name]["state"]
        assert got.keys() == want.keys()
        for i in want:
            assert all(got[i][m].shape == want[i][m].shape for m in ("mu", "nu"))
    resumed = on_shards(2, lambda mesh: fit(mesh, {**over, "epochs": 2,
                                                   "resume_checkpoint": str(tmp_path / "split" / "DiffMM-tiny")}))
    one = fit(None, {**ref_over, "epochs": 2, "resume_checkpoint": str(tmp_path / "one" / "DiffMM-tiny")})
    for k, v in one.items():
        np.testing.assert_allclose(resumed[0][k], v, rtol=2e-4, atol=2e-4, err_msg=k)


# -- the tables held at rest over the model axis --------------------------------
def _held_step(name, params, mesh):
    """A trainer's start on tiny from the JAX parameters ``params`` (numpy),
    placed as ``fit`` places them (on a model axis each table that
    ``shard_model_params`` names held as the rank's rows), then the first
    training batch of epoch 0 (DiffMM's: of its BPR + InfoNCE epoch) → (the
    rows each rank holds, by JAX name, before the batch; the batch's losses;
    every gradient before the step and every parameter after it, whole)."""
    from genmmrec_tpu_torch.parallel import dryrun

    config = TConfig(name, "tiny", dict(ONE_BATCH))
    td = t_train(TDataset(config).split()[0], CPU)
    model = t_get_model(name)(config, td)
    trainer = get_trainer(name)(config, model, mesh=mesh)
    from_jax_params(model, params)
    trainer.state = model.init_state(trainer.split("state"))
    trainer._place_params()
    to_jax = dict(zip(dict(model.named_parameters()), params_by_jax_name(model)))
    held = {to_jax[k]: p.detach().clone().numpy() for k, p in model.named_parameters()
            if getattr(p, "held_rows", None) is not None}
    trainer._build_train_step(td)
    grads = dryrun.record_step_grads(trainer)
    with pm.whole_tables(model):
        trainer.state = model.pre_epoch(trainer.state, trainer.split("epoch", 0, "pre"), 0)
    idx = torch.arange(trainer.train_batch_size)[None]
    losses = trainer._train_epoch(trainer.split("epoch", 0, "train"), plan={"idx": idx})
    return held, losses.numpy(), grads, {k: v.numpy() for k, v in model.state_dict().items()}


def _jax_shards(jm, params, S: int) -> list:
    """For each model index of a ``{data: 1, model: S}`` JAX mesh, the rows
    its devices hold of each leaf that ``shard_model_params`` shards, by JAX
    name (``addressable_shards``)."""
    mesh = JMesh(np.asarray(jax.devices()[:S]).reshape(1, S), ("data", "model"))
    sharded = jmesh.shard_model_params(jm, params, mesh)

    def rows(leaf, r):
        if "model" not in str(leaf.sharding.spec):
            return np.zeros(0)
        per = leaf.shape[0] // S
        (shard,) = [s for s in leaf.addressable_shards if (s.index[0].start or 0) == r * per]
        return np.asarray(shard.data)

    return [{k: v for k, v in jax_tree_by_name(jax.tree_util.tree_map(lambda leaf: rows(leaf, r), sharded)).items()
             if v.size} for r in range(S)]


@pytest.mark.parametrize("name", ["LightGCN", "DiffMM"])
def test_held_tables_are_jax_shards_and_step_as_one_rank(name, request):
    """On ``{data: 1, model: 2}`` each rank holds exactly the rows that the
    JAX ``shard_model_params`` puts on its model index, leaf for leaf (the
    item split's out-projections among them for DiffMM); one training batch
    with the tables at rest gives one rank's losses within 1e-6, its
    gradients (gathered whole) and, after the step, its parameters within
    1e-6 / 1e-7."""
    if name == "DiffMM":
        jm, _, params = request.getfixturevalue("diffmm_pair")
    else:
        jc = JConfig(name, "tiny", dict(ONE_BATCH))
        jm = j_get_model(name)(jc, j_train(JDataset(jc).split()[0]))
        params = jax.jit(jm.init_params)(jax.random.PRNGKey(0))
    shards = _jax_shards(jm, params, 2)
    ref = _held_step(name, _np_tree(params), None)
    got = on_shards(2, lambda mesh: _held_step(name, _np_tree(params), mesh))
    assert ref[0] == {}
    for r, (held, losses, grads, after) in enumerate(got):
        assert held.keys() == shards[r].keys() and held, (sorted(held), sorted(shards[r]))
        for k, v in shards[r].items():
            np.testing.assert_array_equal(held[k], v, err_msg=k)
        np.testing.assert_allclose(losses, ref[1], rtol=1e-6)
        for mine, one in ((grads, ref[2]), (after, ref[3])):
            assert mine.keys() == one.keys() and mine
            for k, v in one.items():
                np.testing.assert_allclose(mine[k], v, rtol=1e-6, atol=1e-7, err_msg=k)


def test_held_tables_layout_checkpoint_and_log(tmp_path, caplog):
    """A BPR fit on ``{data: 1, model: 2}``: each rank holds ``n / 2`` rows
    of each table, and of its gradient and Adam moments; ``state_dict()``
    and the checkpoint give the tables whole, the same on every rank, and
    loading the whole checkpoint on the mesh gives back each rank's rows;
    rank 0 logs the JAX trainer's line of the placement once."""
    caplog.set_level(logging.INFO)
    over = {**ONE_BATCH, "checkpoint_dir": str(tmp_path)}

    def rank(mesh):
        model, trainer = _fit("BPR", mesh, over)
        params = dict(model.named_parameters())
        opt = trainer.optimizers["main"]
        shapes = {k: (tuple(p.shape), p.held_rows.n, {m: tuple(v.shape) for m, v in opt.state[p].items()})
                  for k, p in params.items()}
        whole = {k: v.clone() for k, v in model.state_dict().items()}
        rows = {k: p.detach().clone() for k, p in params.items()}
        with pm.whole_tables(model):
            total, _ = model.loss(trainer.state, {k: torch.arange(8) for k in ("users", "pos", "neg")}
                                  | {"weight": torch.ones(8)})
        total.backward()
        grads = {k: tuple(p.grad.shape) for k, p in params.items()}
        ck = load_checkpoint(str(tmp_path / "BPR-tiny"))
        for p in params.values():
            p.data.zero_()
        model.load_state_dict(ck["params"])
        loaded = {k: torch.equal(p.detach(), rows[k]) for k, p in params.items()}
        return shapes, grads, whole, ck["params"], loaded

    out = on_shards(2, rank)
    n = {"user_emb": 64, "item_emb": 48}
    for shapes, grads, whole, ck, loaded in out:
        assert shapes.keys() == grads.keys() == n.keys()
        for k, (shape, rows, moments) in shapes.items():
            assert shape[0] == n[k] // 2 and rows == n[k] and grads[k] == shape, k
            assert moments == {"mu": shape, "nu": shape}, k
            assert whole[k].shape == ck[k].shape == (n[k], shape[1]) and torch.equal(whole[k], ck[k])
            assert torch.equal(whole[k], out[0][2][k])
        assert all(loaded.values()), loaded
    line = "model-axis sharding: 2 embedding tables row-sharded over 2-way model axis"
    assert caplog.text.count(line) == 1


def test_fit_warns_when_no_table_divides_the_model_axis(caplog):
    """Tables of 63 users and 47 items on ``{data: 1, model: 2}``: none
    qualifies, every table stays whole on each rank, and rank 0 logs the
    JAX trainer's warning once."""
    caplog.set_level(logging.INFO)
    over = {**ONE_BATCH, "synthetic_n_users": 63, "synthetic_n_items": 47}

    def rank(mesh):
        model = _fit("BPR", mesh, over)[0]
        return model.n_users, model.n_items, [getattr(p, "held_rows", None) for p in model.parameters()]

    for users, items, held in on_shards(2, rank):
        assert (users, items) == (63, 47) and held == [None, None]
    warning = "mesh_shape requests a model axis but no parameter leaf qualified for sharding"
    assert caplog.text.count(warning) == 1 and "model-axis sharding" not in caplog.text
