"""The RF models through the port's entry points, on the CPU: ``get_model``
resolves all 20 names (``RFMREC`` is RFMRec), each of the 19 models trains
one epoch and evaluates on tiny through ``quick_start(..., device="cpu")``
(finite losses and metrics), and ``python -m genmmrec_tpu_torch`` runs
RFGUME and RFBM3 in a subprocess; an RF host's log shows its loss parts,
the host's, the flow's and the InfoNCE's."""

import logging
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from genmmrec_tpu_torch.models import get_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = [
    "RFGUME", "RFGUMETime", "RFMRec", "GenRecBM3", "RFBM3", "RFFREEDOM", "RFLATTICE", "RFMGCN", "RFMMGCN", "RFVBPR",
    "RFLGMRec", "RFBPR_remove", "RFLightGCN_remove", "RFLayerGCN_remove", "RFDualGNN", "RFGRCN", "RFCOHESION",
    "RFSMORE", "RFPGL",
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run small products in many processes at once (``-n 6``):
    one torch thread each, for this module only, keeps their OpenMP pools
    from spinning against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_get_model_resolves_every_rf_name():
    classes = {name: get_model(name) for name in MODELS + ["RFMREC"]}
    assert classes["RFMREC"] is classes["RFMRec"]
    assert all(cls.__name__ == name for name, cls in classes.items() if name != "RFMREC")


@pytest.mark.parametrize("name", MODELS)
def test_quick_start_on_tiny(name, tmp_path, monkeypatch):
    """One epoch and both evaluations through ``quick_start`` on the CPU,
    the YAML's grid axis set to one value."""
    from genmmrec_tpu_torch.quick_start import quick_start

    monkeypatch.chdir(tmp_path)
    root = logging.getLogger()
    handlers = list(root.handlers)
    try:
        combo, valid, test = quick_start(name, "tiny", {"save_recommended_topk": False, "rf_loss_weight": 0.2},
                                         save_model=False, max_epochs=1, device="cpu")
    finally:
        for h in list(root.handlers):
            root.removeHandler(h)
            if h not in handlers:
                h.close()
        for h in handlers:
            root.addHandler(h)
    assert 0.0 <= valid["recall@20"] <= 1.0 and "Coverage@50" in test
    assert all(np.isfinite(v) for v in list(valid.values()) + list(test.values()))


def _cli(tmp_path, *args):
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    return subprocess.run(
        [sys.executable, "-m", "genmmrec_tpu_torch", *args], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=600,
    )


@pytest.mark.parametrize("name, columns", [("RFGUME", 1), ("RFBM3", 3)])
def test_cli_runs_an_rf_model_on_the_cpu(name, columns, tmp_path):
    """RFGUME reports its total, as the JAX model does; an RF host reports
    the host's loss, the flow's and the InfoNCE's, each finite."""
    out = _cli(tmp_path, "--device", "cpu", "--model", name, "--dataset", "tiny", "--epochs", "1",
               "--config-json", '{"rf_loss_weight": 0.2}')
    assert out.returncode == 0, out.stderr[-3000:]
    log = out.stderr
    assert log.count("training [time:") == 1 and "█████████████ BEST ████████████████" in log
    line = next(ln for ln in log.splitlines() if "training [time:" in ln)
    losses = re.findall(r"train[ _]loss\d*: (\S+?)[,\]]", line)
    assert len(losses) == columns and all(np.isfinite(float(v)) for v in losses), line
