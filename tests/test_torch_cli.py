"""The port's entry point against the JAX package, on the CPU: the config
tree and its hyper-parameter grid, ``quick_start`` (ItemKNNCBF, which
draws nothing, is held value for value), ``python -m genmmrec_tpu_torch``
and what the CLI adds to ``Trainer.fit``: the mirror-gradient epoch, the
wandb logging and the profiler trace.

Tolerances: scores 1e-5 relative; an epoch of Adam steps 1e-4 relative
(``tests/test_torch_train.py``'s bound); metrics are the evaluators'
dicts, rounded to 4 decimals, and must be equal.
"""

import filecmp
import glob
import itertools
import json
import logging
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import genmmrec_tpu.engine.evaluator as j_evaluator
import genmmrec_tpu_torch.engine.evaluator as t_evaluator
from genmmrec_tpu import config as jcfg
from genmmrec_tpu.config import Config as JConfig
from genmmrec_tpu.data.arrays import build_train_data as j_train
from genmmrec_tpu.data.arrays import sample_negatives as j_sample_negatives
from genmmrec_tpu.data.dataset import RecDataset as JDataset
from genmmrec_tpu.engine.trainer import Trainer as JTrainer
from genmmrec_tpu.models import get_model as j_get_model
from genmmrec_tpu.quick_start import quick_start as j_quick_start
from genmmrec_tpu_torch import config as tcfg
from genmmrec_tpu_torch.config import Config as TConfig
from genmmrec_tpu_torch.data.arrays import build_eval_data as t_eval
from genmmrec_tpu_torch.data.arrays import build_train_data as t_train
from genmmrec_tpu_torch.data.dataset import RecDataset as TDataset
from genmmrec_tpu_torch.engine.evaluator import group_masks
from genmmrec_tpu_torch.engine.trainer import Trainer as TTrainer
from genmmrec_tpu_torch.engine.trainer import get_trainer
from genmmrec_tpu_torch.interop import from_jax_params, jax_tree_by_name, params_by_jax_name
from genmmrec_tpu_torch.models import get_model as t_get_model
from genmmrec_tpu_torch.quick_start import quick_start as t_quick_start
from genmmrec_tpu_torch.utils import misc as tmisc
from genmmrec_tpu_torch.utils.logger import init_logger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
ONE_DEVICE = {"mesh_shape": {"data": 1, "model": 1}}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t.to(dtype) if dtype else t


@pytest.fixture
def root_logging():
    """``quick_start`` replaces the root logger's handlers: put them back."""
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    yield
    for h in list(root.handlers):
        root.removeHandler(h)
        if h not in handlers:
            h.close()
    for h in handlers:
        root.addHandler(h)
    root.setLevel(level)


# ----------------------------------------------------------------------
def test_config_tree_is_byte_equal_to_the_jax_tree():
    """The port's tier files are a copy of the JAX package's: every file,
    byte for byte, so that the copy cannot drift."""
    rel = lambda root: sorted(os.path.relpath(p, root) for p in glob.glob(os.path.join(root, "**", "*"), recursive=True)
                              if os.path.isfile(p) and "__pycache__" not in p)
    files = rel(jcfg._CONFIG_ROOT)
    assert len(files) > 50 and rel(tcfg.CONFIG_ROOT) == files
    for f in files:
        assert filecmp.cmp(os.path.join(tcfg.CONFIG_ROOT, f), os.path.join(jcfg._CONFIG_ROOT, f), shallow=False), f


@pytest.mark.parametrize(
    "model, mg, overrides, n_combos",
    [
        ("ItemKNNCBF", True, {}, 3),
        ("BPR", False, {"learning_rate": [0.1, 0.01], "reg_weight": [1e-3, 1e-4, 0.0],
                        "hyper_parameters": ["learning_rate", "reg_weight", "learning_rate"]}, 6),
    ],
    ids=["itemknncbf_mg", "list_valued_config_dict"],
)
def test_hyper_grid_matches_jax(model, mg, overrides, n_combos):
    ref = list(JConfig(model, "tiny", dict(overrides), mg).hyper_grid())
    got = list(TConfig(model, "tiny", dict(overrides), mg).hyper_grid())
    assert got == ref and len(got) == n_combos
    names = got[0][0]
    assert len(set(names)) == len(names) and "seed" in names


def test_logger_seed_and_dataset_accessors(tmp_path, monkeypatch, root_logging):
    """``init_logger`` twice leaves one file and one stream handler and writes
    under ``./log/``; ``init_seed`` seeds ``random`` and numpy as the JAX
    package does; the dataset's counts."""
    monkeypatch.chdir(tmp_path)
    tc = TConfig("BPR", "tiny", {})
    init_logger(tc)
    init_logger(tc)
    root = logging.getLogger()
    kinds = sorted(type(h).__name__ for h in root.handlers)
    assert kinds == ["FileHandler", "StreamHandler"]
    logging.getLogger().info("hello")
    (log,) = glob.glob(str(tmp_path / "log" / "BPR-tiny-*.log"))
    root.handlers[0].flush()
    assert "hello" in open(log).read()
    import random

    from genmmrec_tpu.utils import misc as jmisc

    tmisc.init_seed(5)
    a = (random.random(), np.random.rand())
    jmisc.init_seed(5)
    assert a == (random.random(), np.random.rand())
    ds, jds = TDataset(tc), JDataset(JConfig("BPR", "tiny", {}))
    assert (ds.get_user_num(), ds.get_item_num()) == (jds.get_user_num(), jds.get_item_num()) == (64, 48)


# ----------------------------------------------------------------------
GRID = {"knn_k": [5, 10], **ONE_DEVICE}


def _quick_start_in(run, cwd, evaluator, monkeypatch, **kwargs):
    """``run`` in ``cwd`` with the CSV names numbered in order of writing
    (the time stamp of a name has a resolution of a second)."""
    monkeypatch.chdir(cwd)
    stamps = itertools.count()
    monkeypatch.setattr(evaluator, "get_local_time", lambda: f"n{next(stamps)}")
    return run("ItemKNNCBF", "tiny", config_dict=dict(GRID), **kwargs)


def test_quick_start_itemknncbf_matches_jax(tmp_path, monkeypatch, root_logging):
    """The whole CLI path, config → data → grid → fit → evaluation → metrics
    → CSV, on a model that draws nothing: each combination's
    ``scores_matrix`` within 1e-5 first, then the returned (combo, best
    valid, best test) and every test CSV's rows. Where two packages'
    lists differ, the two items' scores are a near-tie (1e-5 of the
    largest score): the pair is named."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    ref = _quick_start_in(j_quick_start, tmp_path / "jax", j_evaluator, monkeypatch)
    got = _quick_start_in(t_quick_start, tmp_path / "torch", t_evaluator, monkeypatch, device="cpu")
    assert got[0] == ref[0] == (999, 10, 5)
    assert got[1] == ref[1] and got[2] == ref[2]
    assert set(got[2]) > set(got[1]) and "Pop_Recall@20" in got[2]

    csvs = lambda d: sorted(glob.glob(str(tmp_path / d / "recommend_topk" / "*.csv")))
    j_csv, t_csv = csvs("jax"), csvs("torch")
    assert [os.path.basename(p) for p in t_csv] == [os.path.basename(p) for p in j_csv]
    assert [os.path.basename(p)[-7:] for p in t_csv] == ["-n0.csv", "-n1.csv"]
    assert os.path.isfile(tmp_path / "torch" / "saved" / "ItemKNNCBF-tiny.pt")
    assert glob.glob(str(tmp_path / "torch" / "log" / "ItemKNNCBF-tiny-*.log"))
    for knn_k, jp, tp in zip((5, 10), j_csv, t_csv):
        over = {**GRID, "knn_k": knn_k}
        jc, tc = JConfig("ItemKNNCBF", "tiny", dict(over)), TConfig("ItemKNNCBF", "tiny", dict(over))
        jm = j_get_model("ItemKNNCBF")(jc, j_train(JDataset(jc).split()[0]))
        tm = t_get_model("ItemKNNCBF")(tc, t_train(TDataset(tc).split()[0], CPU))
        scores = np.asarray(jm.scores_matrix)
        np.testing.assert_allclose(tm.scores_matrix.numpy(), scores, rtol=1e-5, atol=1e-6 * np.abs(scores).max())
        with open(tp) as f:
            assert f.readline().split("\t")[:2] == ["id", "top_0"]
        j_rows, t_rows = np.loadtxt(jp, skiprows=1, dtype=np.int64), np.loadtxt(tp, skiprows=1, dtype=np.int64)
        assert t_rows.shape == j_rows.shape and t_rows.shape[1] == 51
        np.testing.assert_array_equal(t_rows[:, 0], j_rows[:, 0])
        tie = 1e-5 * np.abs(scores).max()
        for r, c in zip(*np.nonzero(t_rows[:, 1:] != j_rows[:, 1:])):
            u, a, b = t_rows[r, 0], t_rows[r, 1 + c], j_rows[r, 1 + c]
            gap = abs(scores[u, a] - scores[u, b])
            assert a >= 0 and b >= 0 and gap <= tie, f"user {u}: items {a} and {b} swapped at {c}, gap {gap}"


# ----------------------------------------------------------------------
def test_mirror_gradient_epoch_matches_jax():
    """One BPR epoch under ``mg`` (alpha1 1.0, alpha2 0.3, beta 3) on tiny from
    the same parameters and the JAX package's plan (permutation and
    negatives): the epoch's losses and the parameters after it equal the
    JAX trainer's, which steps twice on every third batch."""
    over = {"train_batch_size": 64, "save_recommended_topk": False, **ONE_DEVICE}
    jc, tc = JConfig("BPR", "tiny", dict(over), True), TConfig("BPR", "tiny", dict(over), True)
    names, combo = list(tc.hyper_grid())[2]
    for name, value in zip(names, combo):
        jc[name] = tc[name] = value
    assert (tc["alpha1"], tc["alpha2"], tc["beta"]) == (1.0, 0.3, 3)
    jtd, ttd = j_train(JDataset(jc).split()[0]), t_train(TDataset(tc).split()[0], CPU)
    jm, tm = j_get_model("BPR")(jc, jtd), t_get_model("BPR")(tc, ttd)
    params = jm.init_params(jax.random.PRNGKey(0))
    from_jax_params(tm, _np_tree(params))
    jtr = JTrainer(jc, jm, mg=True)
    jtr._state = {}
    optimizer, train_epoch = jtr._build_train_step(jtd)
    B, nb, n_inter = jtr.train_batch_size, jtr._num_batches, jtd.n_inter
    assert nb > 2 * jtr.beta
    key = jax.random.PRNGKey(5)
    k_perm, k_scan = jax.random.split(key)
    idxs = jax.random.permutation(k_perm, nb * B).reshape(nb, B)
    keys = jax.random.split(k_scan, nb)
    negs = []
    for b in range(nb):
        users = jtd.users[idxs[b] % n_inter]
        k_neg = jax.random.split(keys[b], 3)[0]
        negs.append(np.asarray(j_sample_negatives(k_neg, users, jtd.hist, jtd.item_pool, jtd.n_pool, jtr.neg_rounds)))
    copy = lambda t: jax.tree_util.tree_map(jnp.array, t)
    p_epoch, _, _, totals = train_epoch(copy(params), optimizer.init(copy(params)), {}, key)
    p_plain, _, _, _ = JTrainer(jc, jm)._build_train_step(jtd)[1](copy(params), optimizer.init(copy(params)), {}, key)

    ttr = TTrainer(tc, tm, mg=True)
    ttr._build_train_step(ttd)
    got = ttr._train_epoch(plan={"idx": _t(idxs, torch.int64), "neg": _t(np.stack(negs), torch.int64)})
    assert got.shape == (nb, 1) and ttr.optimizers["main"].count == nb + -(-nb // 3)
    np.testing.assert_allclose(float(got.sum()), float(totals[0]), rtol=1e-4)
    ref, plain = jax_tree_by_name(_np_tree(p_epoch)), jax_tree_by_name(_np_tree(p_plain))
    for k, v in params_by_jax_name(tm).items():
        np.testing.assert_allclose(v, ref[k], rtol=1e-4, atol=1e-5, err_msg=k)
        assert np.abs(ref[k] - plain[k]).max() > 1e-4, k


@pytest.mark.parametrize("name", ["DiffMM", "GenRecV1", "BPR"])
def test_get_trainer_passes_mg(name):
    """Every trainer takes ``mg`` and reads its three values only under it."""
    tc = TConfig(name, "tiny", {"alpha1": 1.0, "alpha2": 0.2, "beta": 2, "OpenInterestDebiase": False})
    model = t_get_model(name)(tc, t_train(TDataset(tc).split()[0], CPU))
    on, off = get_trainer(name)(tc, model, True), get_trainer(name)(tc, model)
    assert (on.mg, on.alpha1, on.alpha2, on.beta) == (True, 1.0, 0.2, 2)
    assert (off.mg, off.alpha1, off.alpha2, off.beta) == (False, 1.0, 0.0, 1)


# ----------------------------------------------------------------------
class FakeWandb(types.ModuleType):
    """A stand-in for the wandb module that records what is logged."""

    def __init__(self):
        super().__init__("wandb")
        self.run, self.calls = None, []

    def init(self, **kwargs):
        self.calls.append(("init", kwargs["name"], kwargs["project"], tuple(kwargs["tags"]), kwargs["notes"]))
        recorded = self.calls
        self.run = types.SimpleNamespace(summary=types.SimpleNamespace(
            update=lambda d: recorded.append(("summary", tuple(sorted(d))))))
        return self.run

    def log(self, data, step=None):
        assert all(np.isfinite(v) for v in data.values())
        self.calls.append(("log", tuple(sorted(data)), step))

    def finish(self):
        self.calls.append(("finish",))
        self.run = None


def test_wandb_logs_the_same_keys_at_the_same_steps(tmp_path, monkeypatch, root_logging):
    """Both packages' ``quick_start`` over a two-value grid with a fake
    wandb: a run a combination, named alike, and the same keys logged at
    the same steps by ``fit`` and at the end of each combination."""
    over = {"use_wandb": True, "reg_weight": [0.1, 0.01], "hyper_parameters": ["reg_weight"],
            "save_recommended_topk": False, **ONE_DEVICE}
    calls = {}
    for pkg, run, extra in (("jax", j_quick_start, {}), ("torch", t_quick_start, {"device": "cpu"})):
        fake = FakeWandb()
        monkeypatch.setitem(sys.modules, "wandb", fake)
        (tmp_path / pkg).mkdir()
        monkeypatch.chdir(tmp_path / pkg)
        run("BPR", "tiny", config_dict=dict(over), max_epochs=2, save_model=False, **extra)
        calls[pkg] = fake.calls
    assert calls["torch"] == calls["jax"]
    # the name takes the axes after the first, as the JAX package's does:
    # here ``seed``, appended after ``reg_weight``
    assert [c[1] for c in calls["torch"] if c[0] == "init"] == ["BPR_tiny_seed999_seed999"] * 2
    steps = [c[2] for c in calls["torch"] if c[0] == "log"]
    assert steps == [0, 0, 1, 1, None] * 2


def test_wandb_without_an_active_run_logs_nothing(monkeypatch):
    fake = FakeWandb()
    monkeypatch.setitem(sys.modules, "wandb", fake)
    tc = TConfig("BPR", "tiny", {"use_wandb": True})
    model = t_get_model("BPR")(tc, t_train(TDataset(tc).split()[0], CPU))
    assert TTrainer(tc, model)._wandb is None
    fake.run = object()
    assert TTrainer(tc, model)._wandb is fake
    monkeypatch.setitem(sys.modules, "wandb", None)  # not installed
    assert TTrainer(tc, model)._wandb is None


def test_profile_trace_dir_writes_a_trace(tmp_path):
    """``profile_trace_dir``: the first epoch runs under ``torch.profiler`` and
    its Chrome trace lands in the directory; the second runs without."""
    trace_dir = tmp_path / "trace"
    tc = TConfig("BPR", "tiny", {"epochs": 2, "save_recommended_topk": False, "profile_trace_dir": str(trace_dir)})
    tr, va, te = TDataset(tc).split()
    td = t_train(tr, CPU)
    tc["pop_mask"], tc["warm_mask"] = group_masks(tr, CPU)
    trainer = TTrainer(tc, t_get_model("BPR")(tc, td))
    trainer.fit(td, t_eval(va, tr, 64, CPU), None, verbose=False)
    (path,) = glob.glob(str(trace_dir / "*.json"))
    assert os.path.basename(path) == "BPR-tiny-epoch0.json"
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    assert len(trainer.train_loss_dict) == 2 and all(np.isfinite(v) for v in trainer.train_loss_dict.values())


def test_plot_train_loss_writes_a_figure(tmp_path):
    tc = TConfig("BPR", "tiny", {})
    trainer = TTrainer(tc, t_get_model("BPR")(tc, t_train(TDataset(tc).split()[0], CPU)))
    trainer.train_loss_dict = {0: 0.7, 1: 0.6, 2: 0.55}
    trainer.plot_train_loss(save_path=str(tmp_path / "loss.png"))
    import matplotlib.pyplot as plt

    assert list(plt.gca().lines[-1].get_ydata()) == [0.7, 0.6, 0.55]
    plt.close("all")
    assert (tmp_path / "loss.png").stat().st_size > 0


# ----------------------------------------------------------------------
def _cli(tmp_path, *args):
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    return subprocess.run(
        [sys.executable, "-m", "genmmrec_tpu_torch", *args], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=600,
    )


def test_cli_on_the_cpu_prints_the_best_block(tmp_path):
    out = _cli(tmp_path, "--device", "cpu", "--model", "BPR", "--dataset", "tiny", "--epochs", "2")
    assert out.returncode == 0, out.stderr[-3000:]
    log = out.stderr
    assert "Trainable parameters: 7168" in log and "Popular items count" in log and "Warm Users" in log
    assert log.count("training [time:") == 2 and "█████████████ BEST ████████████████" in log
    assert glob.glob(str(tmp_path / "recommend_topk" / "BPR-tiny-idx0-top50-*.csv"))
    assert os.path.isfile(tmp_path / "saved" / "BPR-tiny.pt")


def test_cli_without_a_device_needs_cuda(tmp_path):
    """The default device is the card: with none, the CLI exits non-zero and
    says so, and runs nothing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = _cli(tmp_path, "--model", "BPR", "--dataset", "tiny", "--epochs", "1")
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr and "--device cpu" in out.stderr
    assert not os.path.exists(tmp_path / "log") and not os.path.exists(tmp_path / "saved")
