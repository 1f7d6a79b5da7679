"""The PyTorch port's config, dataset, arrays and features against the JAX
package's, on the CPU. The port must read the same tier files into the same
merged config, and build bit-identical tables and arrays."""

import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from genmmrec_tpu import config as jcfg
from genmmrec_tpu.data.arrays import build_eval_data as j_eval
from genmmrec_tpu.data.arrays import build_train_data as j_train
from genmmrec_tpu.data.dataset import RecDataset as JDataset
from genmmrec_tpu.data.features import load_modal_features as j_features
from genmmrec_tpu_torch import config as tcfg
from genmmrec_tpu_torch.data.arrays import build_eval_data as t_eval
from genmmrec_tpu_torch.data.arrays import build_train_data as t_train
from genmmrec_tpu_torch.data.dataset import RecDataset as TDataset
from genmmrec_tpu_torch.data.features import load_modal_features as t_features

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"synthetic_n_users": 300, "synthetic_n_items": 1600, "synthetic_n_inters": 6000}
CPU = torch.device("cpu")


def _both(model, dataset, overrides=None):
    return (
        jcfg.Config(model, dataset, dict(overrides or {})),
        tcfg.Config(model, dataset, dict(overrides or {})),
    )


def test_config_root_is_the_jax_tree():
    """The port reads its own copy of the JAX package's tier files: the same
    files under the port's package (``tests/test_torch_cli.py`` holds their
    bytes equal)."""
    assert os.path.samefile(tcfg.CONFIG_ROOT, os.path.join(REPO, "genmmrec_tpu_torch", "configs"))
    rel = lambda root: sorted(os.path.relpath(p, root) for p in glob.glob(os.path.join(root, "**", "*.yaml"), recursive=True))
    assert rel(tcfg.CONFIG_ROOT) == rel(jcfg._CONFIG_ROOT)


def test_every_tier_file_parses_like_the_jax_loader():
    files = sorted(glob.glob(os.path.join(tcfg.CONFIG_ROOT, "**", "*.yaml"), recursive=True))
    assert len(files) > 50
    for path in files:
        assert tcfg.load_yaml(path) == jcfg._load_yaml(path), path


@pytest.mark.parametrize("dataset", ["baby", "tiny"])
def test_merged_config_matches(dataset):
    jc, tc = _both("DiffMM", dataset, {"eval_batch_size": 128})
    assert tc.final_config_dict == jc.final_config_dict
    assert tc["learning_rate"] == jc["learning_rate"] and isinstance(tc["noise_min"], float)


@pytest.mark.parametrize("overrides", [{}, SMALL], ids=["tiny", "small"])
def test_dataset_tables_bit_identical(overrides):
    jc, tc = _both("DiffMM", "tiny", overrides)
    jd, td = JDataset(jc), TDataset(tc)
    for f in ("users", "items", "times"):
        np.testing.assert_array_equal(getattr(td.table, f), getattr(jd.table, f))
    np.testing.assert_array_equal(td.labels, jd.labels)
    assert (td.user_num, td.item_num) == (jd.user_num, jd.item_num)
    for jp, tp in zip(jd.split(), td.split()):
        np.testing.assert_array_equal(tp.table.users, jp.table.users)
        np.testing.assert_array_equal(tp.table.items, jp.table.items)
        assert (tp.user_num, tp.item_num, len(tp)) == (jp.user_num, jp.item_num, len(jp))
        assert str(tp) == str(jp)


def test_inter_file_load_matches(tmp_path):
    """A real .inter file: the port's csv reader against the JAX loader."""
    rng = np.random.default_rng(7)
    n = 400
    users = rng.integers(0, 40, n)
    items = rng.integers(0, 90, n)
    labels = rng.integers(0, 3, n)
    ratings = rng.integers(1, 6, n)
    stamps = rng.integers(10**9, 2 * 10**9, n)
    d = tmp_path / "toy"
    d.mkdir()
    with open(d / "toy.inter", "w") as f:
        f.write("userID\titemID\trating\ttimestamp\tx_label\n")
        for row in zip(users, items, ratings, stamps, labels):
            f.write("\t".join(map(str, row)) + "\n")
    over = {"data_path": str(tmp_path), "inter_file_name": "toy.inter"}
    jc, tc = _both("DiffMM", "tiny", over)
    jc["dataset"] = tc["dataset"] = "toy"
    jd, td = JDataset(jc), TDataset(tc)
    for f in ("users", "items", "ratings", "times"):
        np.testing.assert_array_equal(getattr(td.table, f), getattr(jd.table, f))
    np.testing.assert_array_equal(td.labels, jd.labels)
    for jp, tp in zip(jd.split(), td.split()):
        np.testing.assert_array_equal(tp.table.items, jp.table.items)


@pytest.mark.parametrize("overrides", [{}, SMALL], ids=["tiny", "small"])
def test_train_and_eval_arrays_bit_identical(overrides):
    jc, tc = _both("DiffMM", "tiny", overrides)
    j_tr, j_va, j_te = JDataset(jc).split()
    t_tr, t_va, t_te = TDataset(tc).split()
    jt, tt = j_train(j_tr), t_train(t_tr, CPU)
    for f in ("users", "items", "hist", "hist_len"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(), np.asarray(getattr(jt, f)))
    assert (tt.n_users, tt.n_items, tt.n_inter) == (jt.n_users, jt.n_items, jt.n_inter)
    for jsplit, tsplit in ((j_va, t_va), (j_te, t_te)):
        je, te = j_eval(jsplit, j_tr, 64), t_eval(tsplit, t_tr, 64, CPU)
        for f in ("users", "valid", "gt_items", "gt_len", "mask_items", "mask_len"):
            np.testing.assert_array_equal(getattr(te, f).numpy(), np.asarray(getattr(je, f)))
        assert (te.n_users_eval, te.n_items) == (je.n_users_eval, je.n_items)


def test_synthetic_features_bit_identical():
    jc, tc = _both("DiffMM", "tiny", SMALL)
    jv, jt, _, _ = j_features(jc, 1600)
    tv, tt = t_features(tc, 1600)
    np.testing.assert_array_equal(tv, np.asarray(jv))
    np.testing.assert_array_equal(tt, np.asarray(jt))


def test_port_imports_no_jax():
    """Importing every module of the port loads neither jax nor the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import genmmrec_tpu_torch as P\n"
        "names = [m.name for m in pkgutil.walk_packages(P.__path__, 'genmmrec_tpu_torch.')]\n"
        "[importlib.import_module(n) for n in names]\n"
        "assert len(names) >= 20, names\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'genmmrec_tpu.'))"
        " or m == 'genmmrec_tpu']\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_gpu(where, tmp_path):
    """No CUDA device (or no repo around it): a non-zero exit and no result line."""
    cwd = REPO
    if where == "alone":
        (tmp_path / "chip_smoke.py").write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
        cwd = str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("where", ["end", "middle"])
def test_inter_file_with_a_blank_line_loads(where, tmp_path):
    """A blank line in a .inter file, after the last row or between two rows:
    the port skips it as the JAX loader does, and both read the same table
    (four rows, two users, two items)."""
    rows = ["0\t0\t5\t100\t0", "0\t1\t4\t101\t1", "1\t0\t3\t102\t2", "1\t1\t2\t103\t0"]
    lines = rows + [""] if where == "end" else rows[:2] + [""] + rows[2:]
    d = tmp_path / "toy"
    d.mkdir()
    (d / "toy.inter").write_text("userID\titemID\trating\ttimestamp\tx_label\n" + "\n".join(lines) + "\n")
    over = {"data_path": str(tmp_path), "inter_file_name": "toy.inter"}
    jc, tc = _both("DiffMM", "tiny", over)
    jc["dataset"] = tc["dataset"] = "toy"
    jd, td = JDataset(jc), TDataset(tc)
    assert (len(td), td.user_num, td.item_num) == (len(jd), jd.user_num, jd.item_num) == (4, 2, 2)
    for f in ("users", "items", "ratings", "times"):
        np.testing.assert_array_equal(getattr(td.table, f), getattr(jd.table, f))
    np.testing.assert_array_equal(td.labels, jd.labels)
