"""The port's loss-landscape tool (``scripts/visualize_landscape_torch.py``)
against the JAX package's (``scripts/visualize_landscape.py``), on the CPU,
at tiny size.

Held: ``filter_normalize`` against the JAX script's function on the same
numpy leaves, a zero parameter and a zero direction among them; the
``loss_grid`` of BPR and LightGCN, parameters from the JAX initialization
(``interop.from_jax_params``), directions from a numpy seed, the negatives
injected, on 5 × 5 coordinates, against the JAX script's ``loss_at``
computed with jit and nested vmap as the script computes it (rtol 1e-5,
atol 1e-6, float32); BM3's grid, whose loss draws dropout masks, the same
twice, its centre the loss at the checkpoint under the grid's seed, and the
parameters equal bit for bit afterwards; the tool's ``main`` on a
checkpoint of the port.
"""

import contextlib
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genmmrec_tpu.config import Config as JConfig
from genmmrec_tpu.data.arrays import build_train_data as j_train
from genmmrec_tpu.data.dataset import RecDataset as JDataset
from genmmrec_tpu.models import get_model as j_get_model
from genmmrec_tpu_torch.config import Config as TConfig
from genmmrec_tpu_torch.data.arrays import build_train_data as t_train
from genmmrec_tpu_torch.data.dataset import RecDataset as TDataset
from genmmrec_tpu_torch.engine.checkpoint import save_checkpoint
from genmmrec_tpu_torch.interop import from_jax_params, jax_tree_by_name, params_by_jax_name
from genmmrec_tpu_torch.models import get_model as t_get_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
ONE_DEVICE = {"mesh_shape": {"data": 1, "model": 1}, "save_recommended_topk": False}
COORDS = np.linspace(-1.0, 1.0, 5, dtype=np.float32)


def _script(name):
    spec = importlib.util.spec_from_file_location(f"{name}_under_test", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


land = _script("visualize_landscape_torch")
jland = _script("visualize_landscape")


def test_filter_normalize_matches_the_jax_script():
    """Each leaf scaled to its parameter's norm, whole leaves (not per
    filter), the 1e-10 floor on a zero direction; a zero parameter gives a
    zero direction."""
    rng = np.random.default_rng(0)
    shapes = {"a": (7, 3), "b": (5,), "zero_param": (4, 2), "zero_dir": (6,), "c": (2, 3, 4)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    dirs = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    params["zero_param"][:] = 0.0
    dirs["zero_dir"][:] = 0.0
    ref = jland.filter_normalize({k: jnp.asarray(v) for k, v in dirs.items()},
                                 {k: jnp.asarray(v) for k, v in params.items()})
    got = land.filter_normalize({k: torch.from_numpy(v) for k, v in dirs.items()},
                                {k: torch.from_numpy(v) for k, v in params.items()})
    assert got.keys() == ref.keys()
    for k in shapes:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-6, atol=1e-7, err_msg=k)
    assert not got["zero_param"].any() and not got["zero_dir"].any()
    np.testing.assert_allclose(np.linalg.norm(got["a"].numpy()), np.linalg.norm(params["a"]), rtol=1e-6)


def _pair(name):
    jc, tc = JConfig(name, "tiny", dict(ONE_DEVICE)), TConfig(name, "tiny", dict(ONE_DEVICE))
    jtd, ttd = j_train(JDataset(jc).split()[0]), t_train(TDataset(tc).split()[0], CPU)
    jm, tm = j_get_model(name)(jc, jtd), t_get_model(name)(tc, ttd)
    params = jm.init_params(jax.random.PRNGKey(0))
    from_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return jm, tm, jtd, ttd, params


@pytest.mark.parametrize("name", ["BPR", "LightGCN"])
def test_loss_grid_matches_the_jax_script(name):
    """The 5 × 5 grid from the same parameters, directions and batch."""
    jm, tm, jtd, ttd, params = _pair(name)
    rng = np.random.default_rng(1)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    raw = [treedef.unflatten([rng.standard_normal(l.shape).astype(np.float32) for l in leaves]) for _ in range(2)]
    d1, d2 = (jland.filter_normalize(jax.tree_util.tree_map(jnp.asarray, d), params) for d in raw)

    B = 48
    assert np.array_equal(np.asarray(jtd.users[:B]), ttd.users[:B].numpy())
    assert np.array_equal(np.asarray(jtd.items[:B]), ttd.items[:B].numpy())
    neg = rng.integers(0, jm.n_items, B)
    jbatch = {"users": jtd.users[:B], "pos": jtd.items[:B], "neg": jnp.asarray(neg, jnp.int32),
              "weight": jnp.ones((B,))}
    jstate = jm.init_state(jax.random.PRNGKey(0))
    k_loss = jax.random.PRNGKey(2)

    @jax.jit
    def loss_at(a, b):
        p = jax.tree_util.tree_map(lambda w, x, y: w + a * x + b * y, params, d1, d2)
        total, _ = jm.loss(p, jstate, jbatch, k_loss)
        return total

    coords = jnp.asarray(COORDS)
    ref = np.asarray(jax.vmap(lambda a: jax.vmap(lambda b: loss_at(a, b))(coords))(coords))

    # the port's directions: the same leaves under the port's names
    names = dict(zip(params_by_jax_name(tm), (n for n, _ in tm.named_parameters())))
    by_name = lambda tree: {names[k]: torch.from_numpy(np.array(v))
                            for k, v in jax_tree_by_name(jax.tree_util.tree_map(np.asarray, tree)).items()}
    t_params = dict(tm.named_parameters())
    t_d1, t_d2 = (land.filter_normalize(by_name(jax.tree_util.tree_map(jnp.asarray, d)), t_params) for d in raw)
    for k in t_d1:
        np.testing.assert_allclose(t_d1[k].numpy(), by_name(d1)[k].numpy(), rtol=1e-6, atol=1e-7, err_msg=k)
    tbatch = {"users": ttd.users[:B], "pos": ttd.items[:B], "neg": torch.from_numpy(neg), "weight": torch.ones(B)}
    before = {k: p.detach().clone() for k, p in t_params.items()}
    got = land.loss_grid(tm, tm.init_state(), tbatch, by_name(d1), by_name(d2), COORDS, seed=0)
    assert got.shape == (5, 5) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    assert all(torch.equal(p, before[k]) for k, p in t_params.items())


def test_bm3_grid_is_repeatable_and_restores_the_parameters():
    """BM3's loss draws its dropout masks from the generator: with the same
    seed at every point the grid is the same twice, its centre is the loss
    at the checkpoint under that seed, and the parameters come back bit for
    bit."""
    tc = TConfig("BM3", "tiny", dict(ONE_DEVICE))
    td = t_train(TDataset(tc).split()[0], CPU)
    tm = t_get_model("BM3")(tc, td)
    tm.init_params(torch.Generator().manual_seed(0))
    params = dict(tm.named_parameters())
    before = {k: p.detach().clone() for k, p in params.items()}
    d1 = land.filter_normalize(land.random_directions(tm, 1), params)
    d2 = land.filter_normalize(land.random_directions(tm, 2), params)
    batch = land.landscape_batch(td, 64, 3)
    state = tm.init_state()
    g1 = land.loss_grid(tm, state, batch, d1, d2, COORDS, seed=4)
    g2 = land.loss_grid(tm, state, batch, d1, d2, COORDS, seed=4)
    assert np.array_equal(g1, g2) and np.isfinite(g1).all()
    assert all(torch.equal(p, before[k]) for k, p in params.items())
    with torch.no_grad():
        centre = tm.loss(state, batch, torch.Generator().manual_seed(4))[0].item()
        other = tm.loss(state, batch, torch.Generator().manual_seed(5))[0].item()
    assert g1[2, 2] == np.float32(centre) and centre != other
    assert not np.array_equal(land.loss_grid(tm, state, batch, d1, d2, COORDS, seed=5), g1)


def test_main_on_a_port_checkpoint(tmp_path, monkeypatch, capsys):
    """The tool on a LightGCN checkpoint of the port: the JAX tool's line,
    the grid and coordinates in the ``.npz``, a PNG beside it, the report
    in the journal with no kernel launched on the CPU and the grid equal to
    its plain versions'."""
    monkeypatch.chdir(tmp_path)
    over = {**ONE_DEVICE, "hyper_parameters": ["seed"]}
    tc = TConfig("LightGCN", "tiny", dict(over))
    tm = t_get_model("LightGCN")(tc, t_train(TDataset(tc).split()[0], CPU))
    tm.init_params(torch.Generator().manual_seed(0))
    save_checkpoint(str(tmp_path / "saved" / "LightGCN-tiny"), params=tm.state_dict(), state={})
    journal = tmp_path / "j.json"
    rc = land.main(["--model", "LightGCN", "--dataset", "tiny", "--checkpoint", "saved/LightGCN-tiny.pt",
                    "--steps", "5", "--distance", "2", "--device", "cpu", "--against-plain",
                    "--config-json", json.dumps(over), "--journal", str(journal)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "loss at checkpoint = " in out
    f = np.load(tmp_path / "landscape_LightGCN_tiny.npz")
    assert f["grid"].shape == (5, 5) and np.array_equal(f["coords"], np.linspace(-1, 1, 5, dtype=np.float32))
    assert (tmp_path / "landscape_LightGCN_tiny.png").stat().st_size > 0
    report = json.load(open(journal))["landscape/LightGCN/tiny"]
    assert report["card"] == "cpu" and report["max_abs_diff_to_plain"] == 0.0 and not any(report["launches"].values())
    assert report["loss_at_checkpoint"] == float(f["grid"][2, 2])
    assert f"loss at checkpoint = {f['grid'][2, 2]:.4f}" in out


@pytest.mark.parametrize("swap_holds", [True, False], ids=["swapped", "not_swapped"])
def test_against_plain_fails_when_a_kernel_launches_on_the_plain_grid(tmp_path, monkeypatch, swap_holds):
    """``--against-plain`` exits 1 when a K1/K2 wrapper is still called on
    the plain grid (here the swap is left out and the wrappers count their
    calls, as they count launches on the card), 0 when the swap holds."""
    from genmmrec_tpu_torch import ops
    from genmmrec_tpu_torch.ops import segment as S

    calls = [0]

    def counting(f):
        def wrapper(*a, **k):
            calls[0] += 1
            return f(*a, **k)
        return wrapper

    for name in ("segment_spmm", "segment_spmm_blocked"):
        monkeypatch.setattr(S, name, counting(getattr(S, name)))
    monkeypatch.setattr(ops, "launch_counts", lambda: {"segment_spmm": calls[0]})
    if not swap_holds:
        monkeypatch.setattr(land, "plain_versions", contextlib.nullcontext)
    monkeypatch.chdir(tmp_path)
    over = {**ONE_DEVICE, "hyper_parameters": ["seed"]}
    tc = TConfig("LightGCN", "tiny", dict(over))
    tm = t_get_model("LightGCN")(tc, t_train(TDataset(tc).split()[0], CPU))
    tm.init_params(torch.Generator().manual_seed(0))
    save_checkpoint(str(tmp_path / "saved" / "LightGCN-tiny"), params=tm.state_dict(), state={})
    journal = tmp_path / "j.json"
    rc = land.main(["--model", "LightGCN", "--dataset", "tiny", "--checkpoint", "saved/LightGCN-tiny.pt",
                    "--steps", "3", "--distance", "2", "--device", "cpu", "--against-plain",
                    "--config-json", json.dumps(over), "--journal", str(journal)])
    report = json.load(open(journal))["landscape/LightGCN/tiny"]
    assert report["launches"]["segment_spmm"] > 0
    assert (report["plain_launches"]["segment_spmm"] == 0) == swap_holds
    assert rc == (0 if swap_holds else 1)
