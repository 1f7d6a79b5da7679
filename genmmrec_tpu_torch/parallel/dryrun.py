"""Whole runs of the port on a mesh held against one rank.

``dryrun_multigpu(n)`` is the counterpart of ``__graft_entry__.py``
``dryrun_multichip``: DiffMM and GenRecV1, one full fit epoch each at the
tiny size (phase 1, the regeneration, the BPR epoch, the evaluation) on a
``{data: n/2, model: 2}`` mesh (``{data: n}`` for an odd ``n``) and again on
one rank; every valid metric must agree within ``METRIC_ATOL``.

``mesh_checks`` is the entry of the ranks that ``tests/test_torch_mesh.py``
starts on the CPU (it lives here, so that the spawned ranks import ``torch``
and this package alone): fits on a 2 × 2 mesh and on a data axis alone,
each model's batch gradients from the parameters, state, graphs and batch
its case gives (``batch_grads``; the cases may be handed over in a file
while the ranks fit, ``handed_over``), one training batch under a model
axis alone, and the diffusion phases on the model axis's item split: one
phase-1 batch of DiffMM, GenRecV1 and MVDiff (``phase1_batch``) on a model
axis alone and DiffMM's phase 1 and regeneration on the 2 × 2 mesh
(``regeneration``). On every model axis the tables are held as each
rank's rows (``Trainer._place_params``; ``batch_grads`` holds them
itself), and what each returns is whole.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from genmmrec_tpu_torch.config import Config
from genmmrec_tpu_torch.data.arrays import build_eval_data, build_train_data
from genmmrec_tpu_torch.data.dataset import RecDataset
from genmmrec_tpu_torch.engine.evaluator import group_masks
from genmmrec_tpu_torch.engine.trainer import get_trainer
from genmmrec_tpu_torch.models import get_model
from genmmrec_tpu_torch.parallel import launch
from genmmrec_tpu_torch.parallel import mesh as pm

# the JAX package's bound on a sharded fit's metrics against one device
METRIC_ATOL = 2e-3
DRYRUN = {
    "save_recommended_topk": False,
    "epochs": 1,
    "train_batch_size": 64,
    "eval_batch_size": 64,
    "topk": [5, 10],
    "metrics": ["Recall", "NDCG"],
    "valid_metric": "Recall@10",
    "hyper_parameters": ["seed"],
}


def fit(model_name: str, overrides: dict, device, mesh=None, dataset: str = "tiny", saved: bool = False):
    """One ``fit`` of ``model_name`` (``saved``: with its checkpoints) →
    (best valid score, valid result, test result, the parameters by name
    as numpy arrays)."""
    config = Config(model_name, dataset, dict(overrides))
    train, valid, test = RecDataset(config).split()
    td = build_train_data(train, device)
    ebs = int(config["eval_batch_size"])
    vd, sd = build_eval_data(valid, train, ebs, device), build_eval_data(test, train, ebs, device)
    config["pop_mask"], config["warm_mask"] = group_masks(train, device)
    model = get_model(model_name)(config, td)
    trainer = get_trainer(model_name)(config, model, mesh=mesh)
    score, valid_res, test_res = trainer.fit(td, vd, sd, saved=saved, verbose=False)
    params = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    return score, valid_res, test_res, params


def _fits_rank(device, names, mesh_shape):
    mesh = pm.build_mesh({"mesh_shape": mesh_shape})
    return {name: fit(name, DRYRUN, device, mesh)[:2] for name in names}


def dryrun_multigpu(n: int, device="cuda", names=("DiffMM", "GenRecV1")) -> dict:
    """Fit each model on an ``n``-rank mesh and on one rank, hold every
    valid metric within ``METRIC_ATOL``; returns {name: (mesh result, one
    rank's result)}."""
    mesh_shape = {"data": n // 2, "model": 2} if n % 2 == 0 else {"data": n, "model": 1}
    on_mesh = launch.run(_fits_rank, mesh_shape, device, (names, mesh_shape))
    out = {}
    for name in names:
        score_sh, valid_sh = on_mesh[name]
        score_1, valid_1 = fit(name, DRYRUN, torch.device(device))[:2]
        if not np.isfinite(score_sh):
            raise AssertionError(f"{name}: the mesh fit's valid score is not finite")
        off = {k: (valid_1[k], valid_sh[k]) for k in valid_1 if abs(valid_1[k] - valid_sh[k]) >= METRIC_ATOL}
        if off:
            raise AssertionError(f"{name}: the {mesh_shape} fit diverged from one rank: {off}")
        print(f"dryrun_multigpu({n}) {name} OK: mesh={mesh_shape}, valid Recall@10 mesh={score_sh:.4f} "
              f"one rank={score_1:.4f}")
        out[name] = (valid_sh, valid_1)
    return out


# -- the ranks of tests/test_torch_mesh.py -----------------------------------
def _on(x, device):
    """``x`` (arrays, tensors, and dicts, tuples and lists of them) on ``device``."""
    if isinstance(x, dict):
        return {k: _on(v, device) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_on(v, device) for v in x)
    if isinstance(x, (np.ndarray, np.generic)) or torch.is_tensor(x):
        return torch.as_tensor(x, device=device)
    return x


def case_model(case: dict, device):
    """The model of a ``batch_grads`` case and its state: the model on its
    tiny data with the case's graphs in place of its own (``graphs``: name ->
    ``rows``, ``cols``, ``vals``, ``n_rows``, ``n_cols`` of the JAX graph, in
    its order), the case's tables or draws in place of other attributes
    (``attrs``: name -> arrays, as the model holds them) and its JAX
    parameters (numpy, ``interop.from_jax_params``); the state from the JAX
    state's arrays (``jax_state``, ``interop.from_jax_state``), or the
    model's own ``init_state()`` (``init_state``), with the values of
    ``state_values`` in place of its own, and from ``rebuild_ui_graph``
    arguments (``state``: name -> (top, keywords))."""
    from genmmrec_tpu_torch.interop import from_jax_params, from_jax_state
    from genmmrec_tpu_torch.ops.graph import sorted_graph

    config = Config(case["model"], "tiny", dict(case["overrides"]))
    train = RecDataset(config).split()[0]
    model = get_model(case["model"])(config, build_train_data(train, device))
    for name, g in case.get("graphs", {}).items():
        edges = (torch.as_tensor(g[k], device=device) for k in ("rows", "cols", "vals"))
        setattr(model, name, sorted_graph(*edges, g["n_rows"], g["n_cols"]))
    for name, value in case.get("attrs", {}).items():
        setattr(model, name, _on(value, device))
    from_jax_params(model, case["params"])
    if case.get("init_state"):
        state = model.init_state()
    else:
        state = from_jax_state(model, case["jax_state"]) if "jax_state" in case else {}
    state.update(case.get("state_values", {}))
    state.update({k: model.rebuild_ui_graph(torch.as_tensor(top, device=device), **_on(kw, device))
                  for k, (top, kw) in case.get("state", {}).items()})
    return model, state


def whole_grads(params: dict) -> dict:
    """name -> each parameter's gradient, whole (a parameter held as this
    rank's rows gathered over the model axis: every model rank must call
    it), zero where it has none, as numpy on the CPU."""
    out = {}
    for k, p in params.items():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        held = getattr(p, "held_rows", None)
        out[k] = (g if held is None else held.gather(g, 0)).cpu().numpy()
    return out


def batch_grads(case: dict, device, mesh=None) -> dict:
    """One batch of ``case`` split over the data axis of ``mesh`` (on one
    rank without it), with the tables held as each model rank's rows
    (``hold_table_rows``) on its model axis: the loss (summed over the data
    axis), every parameter's gradient (summed; zero where the loss reads
    none) whole, by name, the JAX names of the parameters in the same order
    (``interop.params_by_jax_name``) and the floating tensors of the state
    that the batch writes anew (``loss_and_update``). ``case`` holds the
    model, its config overrides, what ``case_model`` builds it from, the
    global batch and the loss's keyword draws (the global batch's)."""
    model, state = case_model(case, device)
    pm.hold_table_rows(model, mesh)
    batch = {k: torch.as_tensor(v, device=device) for k, v in case["batch"].items()}
    if mesh is not None:
        rows = pm.DataRows(mesh, batch["users"].shape[0])
        batch = {**rows.local(batch), "rows": rows}
    with pm.whole_tables(model):
        total, (_, new_state) = model.loss_and_update(state, batch, **_on(case["draws"], device))
    total.backward()
    params = dict(model.named_parameters())
    loss = total.detach().clone()
    if mesh is not None:
        pm.reduce_grads(params.values(), mesh)
        pm.all_reduce(loss, mesh, pm.DATA_AXIS)
    grads = whole_grads(params)
    written = {k: v.detach().cpu().numpy() for k, v in (new_state or {}).items()
               if torch.is_tensor(v) and v.is_floating_point() and v is not state.get(k)}
    from genmmrec_tpu_torch.interop import params_by_jax_name

    return {"loss": float(loss), "grads": grads, "jax_names": list(params_by_jax_name(model)), "state": written}


def one_batch(model_name: str, overrides: dict, device, mesh=None) -> dict:
    """``fit``'s start (the tables held as each model rank's rows) and the
    first training batch of epoch 0 (its first ``train_batch_size`` slots)
    → the parameters after the optimizers stepped, by name and whole."""
    config = Config(model_name, "tiny", dict(overrides))
    train = RecDataset(config).split()[0]
    td = build_train_data(train, device)
    model = get_model(model_name)(config, td)
    trainer = get_trainer(model_name)(config, model, mesh=mesh)
    model.init_params(trainer.split("init"))
    trainer.state = model.init_state(trainer.split("state"))
    trainer._place_params()
    trainer._build_train_step(td)
    with pm.whole_tables(model):
        trainer.state = model.pre_epoch(trainer.state, trainer.split("epoch", 0, "pre"), 0)
    idx = torch.arange(trainer.train_batch_size, device=device)[None]
    trainer._train_epoch(trainer.split("epoch", 0, "train"), plan={"idx": idx})
    return {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}


def _diffusion_trainer(model_name: str, overrides: dict, device, mesh=None, params=None):
    """``fit``'s start for a multi-phase trainer: the model from the seed
    (or from the JAX parameters ``params``, ``interop.from_jax_params``),
    its state, rank 0's values on every rank, the denoisers on the item
    split and the tables held as each model rank's rows, and the
    optimizers → (trainer, train data)."""
    from genmmrec_tpu_torch.interop import from_jax_params

    config = Config(model_name, "tiny", dict(overrides))
    td = build_train_data(RecDataset(config).split()[0], device)
    model = get_model(model_name)(config, td)
    trainer = get_trainer(model_name)(config, model, mesh=mesh)
    model.init_params(trainer.split("init"))
    if params is not None:
        from_jax_params(model, params)
    trainer.state = model.init_state(trainer.split("state"))
    trainer._place_params()
    trainer._build_train_step(td)
    return trainer, td


def record_step_grads(trainer) -> dict:
    """A dict that each optimizer step of ``trainer`` fills, before it
    steps, with the gradient of every parameter it steps (name -> numpy on
    the CPU, whole: one held as rows gathered over the model axis, so every
    model rank must step)."""
    names = {id(p): k for k, p in trainer.model.named_parameters()}
    grads = {}
    for opt in trainer.optimizers.values():
        def recorded(closure=None, opt=opt, step=opt.step):
            grads.update(whole_grads({names[id(p)]: p for group in opt.param_groups for p in group["params"]}))
            return step(closure)

        opt.step = recorded
    return grads


def phase1_batch(model_name: str, overrides: dict, device, mesh=None, case=None) -> dict:
    """``fit``'s start, then the first batch of the phase over (B, n_items)
    vectors (phase 1; MVDiff's phase 3, after its phases 1 and 2) from the
    prelude's generator, or from ``case`` (``params``, JAX parameters, and
    ``plan``, the phase's draws) → its losses, each denoiser's gradient
    before its step and every parameter after it, by name and whole."""
    params = None if case is None else case["params"]
    trainer, _ = _diffusion_trainer(model_name, overrides, device, mesh, params)
    model = trainer.model
    grads = record_step_grads(trainer)
    gen = trainer.split("epoch", 0, "prelude")
    plan = None if case is None else _on(case["plan"], device)
    if model_name == "MVDiff":
        trainer.feature_epoch(gen)
        trainer.regenerate_items()
        grads.clear()
        losses = trainer.sparsity_epoch(gen, plan)
    else:
        losses = trainer._diffusion_epoch(gen, plan)
    # the first batch's losses, as _diffusion_epoch gives them
    params = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    return {"losses": losses[0].cpu().numpy(), "grads": grads, "params": params,
            "split": sorted(k for k, p in model.named_parameters() if isinstance(getattr(p, "held_rows", None),
                                                                                  pm.ItemCols))}


def regeneration(model_name: str, overrides: dict, device, mesh=None) -> dict:
    """``fit``'s start, phase 1 and the regeneration from the prelude's
    generator → the generated graphs' edges (rows, cols, vals) by name."""
    trainer, _ = _diffusion_trainer(model_name, overrides, device, mesh)
    gen = trainer.split("epoch", 0, "prelude")
    trainer._diffusion_epoch(gen)
    state = trainer.regenerate(gen)
    return {k: tuple(getattr(g, f).cpu().numpy() for f in ("rows", "cols", "vals"))
            for k, g in state.items() if k.endswith("_ui")}


def fit_and_resume(model_name: str, overrides: dict, device, mesh=None) -> tuple:
    """``fit`` with checkpoints into ``overrides["checkpoint_dir"]``, then a
    ``fit`` of one more epoch resumed from the last checkpoint → (the
    checkpoint's optimizer states, the resumed fit's parameters)."""
    from genmmrec_tpu_torch.engine.checkpoint import load_checkpoint

    fit(model_name, overrides, device, mesh, saved=True)
    path = f"{overrides['checkpoint_dir']}/{model_name}-tiny"
    states = load_checkpoint(path)["optimizers"]
    resumed = fit(model_name, {**overrides, "epochs": overrides["epochs"] + 1, "resume_checkpoint": path}, device, mesh)
    return states, resumed[3]


def handed_over(path: str, timeout_s: float = 600.0):
    """What the file at ``path`` holds once it appears (its writer saves it
    whole, then renames it into place); raises if it holds None or does
    not appear within ``timeout_s``."""
    t0 = time.time()
    while not os.path.exists(path):
        if time.time() - t0 > timeout_s:
            raise TimeoutError(f"{path} did not appear within {timeout_s} s")
        time.sleep(0.1)
    value = torch.load(path, weights_only=False)
    if value is None:
        raise RuntimeError(f"the writer of {path} failed")
    return value


def mesh_checks(device, spec: dict) -> dict:
    """The scenarios of ``spec`` on a 4-rank world: ``fits`` (model ->
    overrides) on a 2 × 2 mesh, ``resumes`` (``fit_and_resume``) and
    ``batches`` (``batch_grads`` cases, or the path of a file that will
    hold them: the caller may build them while the ranks fit,
    ``handed_over``) on it, ``steps`` (model -> overrides) on a ``{data:
    1, model: 2}`` mesh of the first two ranks, ``data_fits`` (model ->
    overrides) on a ``{data: 2}`` mesh of the first two ranks; on the item
    split, ``regenerations`` (model -> overrides) on the 2 × 2 mesh and
    ``phase1`` (model -> overrides, ``phase1_batch``) on the ``{data: 1,
    model: 2}`` mesh, a model's case taken from the handed-over batches
    under the key ``phase1_cases`` maps to it. Returns global rank 0's
    results."""
    mesh = pm.build_mesh({"mesh_shape": {"data": 2, "model": 2}})
    out = {f"fit_{name}": fit(name, over, device, mesh) for name, over in spec["fits"].items()}
    out.update({f"resume_{name}": fit_and_resume(name, over, device, mesh) for name, over in spec["resumes"].items()})
    out.update({f"regen_{name}": regeneration(name, over, device, mesh)
                for name, over in spec.get("regenerations", {}).items()})
    batches = spec["batches"]
    if isinstance(batches, str):
        batches = handed_over(batches)
    # a case of phase1_cases (model -> case) is phase 1 from JAX parameters and draws
    phase1_cases = {name: batches.pop(key) for key, name in spec.get("phase1_cases", {}).items() if key in batches}
    out.update({f"grad_{name}": batch_grads(case, device, mesh) for name, case in batches.items()})
    model_axis = pm.build_mesh({"mesh_shape": {"data": 1, "model": 2}})
    if model_axis.member:
        out.update({f"step_{name}": one_batch(name, over, device, model_axis) for name, over in spec["steps"].items()})
        out.update({f"phase1_{name}": phase1_batch(name, over, device, model_axis, phase1_cases.get(name))
                    for name, over in spec.get("phase1", {}).items()})
    data_axis = pm.build_mesh({"mesh_shape": {"data": 2}})
    if data_axis.member:
        out.update({f"data_fit_{name}": fit(name, over, device, data_axis)
                    for name, over in spec.get("data_fits", {}).items()})
    return out
