"""The port's experiment harnesses (``scripts/*_torch.py``, layer L8)
against the JAX package's (``compare_models.py``, ``compare_results.py``,
``run_rf_models.py``, ``scripts/run_rfgume.py``,
``scripts/run_ablation_prior.py``, ``scripts/run_rf_staged_search.py``),
on the CPU, at tiny size.

Held: each table equal to the JAX script's; with ``subprocess.run``
captured, each harness's children next to the JAX harness's: the port's
command line (``python -m genmmrec_tpu_torch ... --device``, never
``main.py``), the same override JSON in the same order, the port's work
directory as the working directory, the override files removed, the same
values picked by the staged search; the parsers (``parse_results``,
``parse_log_file``, the search's ``recall@20:`` rule) equal to the JAX ones
on a real log of the port; and one real child on the CPU,
``run_rf_models_torch.py --device cpu -d tiny --models RFBM3 --use_rf false
--epochs 1``, with its journal row, the log comparison and the report.
"""

import glob
import importlib.util
import json
import os
import re
import runpy
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port(name):
    return _load(os.path.join(SCRIPTS, f"{name}_torch.py"), f"{name}_torch")


def _jax(name):
    path = os.path.join(REPO, f"{name}.py")
    return _load(path if os.path.exists(path) else os.path.join(SCRIPTS, f"{name}.py"), f"{name}_jax_under_test")


class Children:
    """``subprocess.run`` captured: each call's command, working directory
    and override JSON (read before the harness removes it); it answers with
    ``log(overrides)``."""

    def __init__(self, log):
        self.calls, self.log = [], log

    def __call__(self, cmd, cwd=None, **kw):
        conf = None
        if "--config-json" in cmd:
            with open(cmd[cmd.index("--config-json") + 1]) as f:
                conf = json.load(f)
        self.calls.append(dict(cmd=list(cmd), cwd=cwd, conf=conf, path=cmd[cmd.index("--config-json") + 1]
                               if conf is not None else None))
        return subprocess.CompletedProcess(cmd, 0, stdout=self.log(conf or {}), stderr="")


def fake_log(conf):
    """A CLI log whose Recall@20 follows the staged search's values (the
    largest at rf_loss_weight 0.4, rf_learning_rate 1e-3, mix 0.02)."""
    score = {0.4: 0.03, 1e-3: 0.02, 0.02: 0.01}
    r = 0.1 + sum(score.get(conf.get(k), 0.0) for k in ("rf_loss_weight", "rf_learning_rate", "rf_inference_mix_ratio"))
    return (f"=========1/1: Parameters:['seed']=(999,)=======\nepoch 0 training [time: 0.10s, train loss: 0.6931]\n"
            f"epoch 0 evaluating [time: 0.10s, valid_score: {r:.6f}]\n\n█████████████ BEST ████████████████\n"
            f"\tParameters: ['seed']=(999,),\nValid: recall@20: {r:.4f}    ndcg@20: 0.0500    ,\n"
            f"Test: recall@20: {r:.4f}    ndcg@20: 0.0400    Pop_Recall@20: 0.9000    \n\n")


@pytest.fixture
def children(monkeypatch):
    c = Children(fake_log)
    monkeypatch.setattr(subprocess, "run", c)
    return c


def _same_children(port, jax, device="cpu", epochs=1):
    """The port's children against the JAX harness's: the same overrides
    in the same order, the port's command and working directory, the
    override files removed."""
    assert len(port) == len(jax) > 0
    for p, j in zip(port, jax):
        assert p["conf"] == j["conf"]
        assert "main.py" in j["cmd"] and not any("main.py" in c for c in p["cmd"])
        model, ds = j["cmd"][j["cmd"].index("-m") + 1], j["cmd"][j["cmd"].index("-d") + 1]
        want = [sys.executable, "-m", "genmmrec_tpu_torch", "-m", model, "-d", ds]
        if p["conf"] is not None:
            want += ["--config-json", p["path"]]
        want += ["--device", device] + (["--epochs", str(epochs)] if epochs else [])
        assert p["cmd"] == want
        assert p["path"] is None or not os.path.exists(p["path"])


# ----------------------------------------------------------------------
def test_tables_equal_the_jax_scripts(monkeypatch):
    rf, jrf = _port("run_rf_models"), _jax("run_rf_models")
    assert rf.ALL_RF_MODELS == jrf.ALL_RF_MODELS and len(rf.ALL_RF_MODELS) == 17
    assert rf.MODEL_DATASET_CONFIGS == jrf.MODEL_DATASET_CONFIGS
    assert _port("run_rfgume").DATASET_CONFIGS == _jax("run_rfgume").DATASET_CONFIGS
    monkeypatch.syspath_prepend(SCRIPTS)  # the JAX ablation imports run_rfgume
    abl, ref = _port("run_ablation_prior").ABLATIONS, _jax("run_ablation_prior").ABLATIONS
    assert abl == ref and list(abl) == list(ref)
    assert _port("run_rf_staged_search").STAGES == _jax("run_rf_staged_search").STAGES
    assert _port("compare_results").METRIC_PATTERNS == _jax("compare_results").METRIC_PATTERNS


@pytest.mark.parametrize("dataset", ["baby", "clothing"])
def test_rf_models_children(children, tmp_path, dataset):
    """``run_one`` of every (model, use_rf) the comparison script runs."""
    port, jax_side = _port("run_rf_models"), _jax("run_rf_models")
    models = ["RFBM3", "RFLGMRec", "RFSMORE", "RFFREEDOM", "RFGUME"]
    for m in models:
        for flag in (True, False):
            jax_side.run_one(m, dataset, flag, epochs=1)
    jax_calls, children.calls = children.calls, []
    assert port.main(["--dataset", dataset, "--models", *models, "--use_rf", "true", "false", "--epochs", "1",
                      "--device", "cpu", "--workdir", str(tmp_path)]) == 0
    _same_children(children.calls, jax_calls)
    assert all(c["cwd"] == str(tmp_path) for c in children.calls)
    assert [c["conf"]["use_rf"] for c in children.calls] == [True, False] * len(models)
    assert children.calls[2]["conf"]["hyper_num"] == (64 if dataset == "clothing" else 4)


def test_rfgume_and_ablation_children(children, tmp_path, monkeypatch):
    """``run_rfgume`` at every dataset, then the four ablations at baby."""
    port_rfgume = _port("run_rfgume")
    jax_rfgume = _jax("run_rfgume")
    for ds in jax_rfgume.DATASET_CONFIGS:
        jax_rfgume.run(ds, 1)
    monkeypatch.syspath_prepend(SCRIPTS)
    monkeypatch.setattr(sys, "argv", ["run_ablation_prior.py", "--dataset", "baby", "--epochs", "1"])
    runpy.run_path(os.path.join(SCRIPTS, "run_ablation_prior.py"), run_name="__main__")
    jax_calls, children.calls = children.calls, []
    journal = tmp_path / "j.json"
    common = ["--epochs", "1", "--device", "cpu", "--workdir", str(tmp_path), "--journal", str(journal)]
    assert port_rfgume.main(["--dataset", "all", *common]) == 0
    assert _port("run_ablation_prior").main(["--dataset", "baby", *common]) == 0
    _same_children(children.calls, jax_calls)
    assert [c["conf"]["user_guidance_scale"] for c in children.calls[3:]] == [0.0, 0.2, 0.0, 0.2]
    rows = json.load(open(journal))
    assert set(rows) == {"RFGUME/baby", "RFGUME/sports", "RFGUME/clothing", *(f"RFGUME/baby/{a}" for a in
                                                                              ("baseline", "user_only", "cosine_only",
                                                                               "both"))}
    assert all(r["ok"] and r["harness"] in ("run_rfgume_torch", "run_ablation_prior_torch") for r in rows.values())


def test_staged_search_children_and_picks(children, tmp_path, monkeypatch):
    """Three stages: the same nine override files (each with
    ``hyper_parameters: []``), the same value picked at each stage, the
    same state; the JAX state file untouched, the port's in its work
    directory."""
    jax_side, port = _jax("run_rf_staged_search"), _port("run_rf_staged_search")
    monkeypatch.setattr(jax_side, "STATE_FILE", str(tmp_path / "jax_state.json"))
    for st in (1, 2, 3):
        jax_side.run_stage("RFGUME", "baby", st, 1)
    jax_calls, children.calls = children.calls, []
    work = tmp_path / "work"
    assert port.main(["--dataset", "baby", "--models", "RFGUME", "--epochs", "1", "--device", "cpu", "--workdir",
                      str(work)]) == 0
    _same_children(children.calls, jax_calls)
    assert all(c["conf"]["hyper_parameters"] == [] for c in children.calls)
    want = {"RFGUME:baby": {"rf_loss_weight": 0.4, "rf_learning_rate": 1e-3, "rf_inference_mix_ratio": 0.02}}
    assert json.load(open(tmp_path / "jax_state.json")) == want
    assert json.load(open(work / port.STATE_NAME)) == want


def test_compare_models_children(children, tmp_path, monkeypatch):
    """``run_model``: the same child but for the command, the same parse of
    its output, the log in the port's work directory."""
    monkeypatch.chdir(tmp_path)
    jax_side, port = _jax("compare_models"), _port("compare_models")
    ref, _ = jax_side.run_model("DiffMM", "baby", 60, ["--epochs", "1"])
    jax_calls, children.calls = children.calls, []
    got, log = port.run_model("DiffMM", "baby", 60, ["--epochs", "1"], device="cpu", workdir=str(tmp_path / "w"))
    _same_children(children.calls, jax_calls)
    assert got == ref and got["test"]["recall@20"] == 0.1 and got["test"]["Pop_Recall@20"] == 0.9
    assert log.startswith(str(tmp_path / "w" / "comparison_logs"))
    assert port.main(["--models", "DiffMM", "--epochs", "1", "--device", "cpu", "--workdir", str(tmp_path / "w")]) == 0
    assert json.load(open(tmp_path / "w" / "comparison_results_torch.json")) == {"DiffMM": ref}


def test_shell_scripts_call_the_port():
    """The two comparison scripts and the script of the five runs name the
    port's harnesses, never the JAX CLI."""
    for name, script in (("run_comparison_torch.sh", "compare_models_torch.py"),
                         ("run_rf_comparison_torch.sh", "run_rf_models_torch.py")):
        src = open(os.path.join(SCRIPTS, name)).read()
        assert script in src and "main.py" not in src and "compare_models.py" not in src.replace("_torch.py", "")
    assert "compare_results_torch.py" in open(os.path.join(SCRIPTS, "run_rf_comparison_torch.sh")).read()
    runs = open(os.path.join(SCRIPTS, "run_harnesses_torch.sh")).read()
    for script in ("run_ablation_prior_torch.py", "run_rf_comparison_torch.sh", "run_comparison_torch.sh",
                   "run_rf_staged_search_torch.py", "visualize_landscape_torch.py", "harness_report_torch.py"):
        assert script in runs, script
    assert "main.py" not in runs


# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def real_child(tmp_path_factory):
    """``run_rf_models_torch.py --device cpu -d tiny --models RFBM3
    --use_rf false --epochs 1`` in a child process: (work directory,
    journal rows, the child's CLI log)."""
    work = tmp_path_factory.mktemp("harness")
    journal = work / "j.json"
    run = subprocess.run(
        [sys.executable, os.path.join(SCRIPTS, "run_rf_models_torch.py"), "--device", "cpu", "-d", "tiny", "--models",
         "RFBM3", "--use_rf", "false", "--epochs", "1", "--workdir", str(work), "--journal", str(journal)],
        capture_output=True, text=True, timeout=300,
    )
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    (log,) = glob.glob(str(work / "log" / "RFBM3-tiny-*.log"))
    return work, json.load(open(journal)), open(log, encoding="utf-8").read()


def test_real_child_on_the_cpu(real_child):
    """The row: OK, the YAML's grid of three, one epoch each, before the
    warm-up, finite values equal to the log's BEST block, no kernel
    launched on the CPU, the port's command."""
    work, rows, log = real_child
    row = rows["RFBM3/tiny/norf"]
    assert row["ok"] and row["returncode"] == 0 and row["card"] == "cpu" and row["overrides"] == {"use_rf": False}
    assert row["command"][:3] == ["python", "-m", "genmmrec_tpu_torch"] and row["command"][-4:] == [
        "--device", "cpu", "--epochs", "1"]
    assert [c["epochs_run"] for c in row["combinations"]] == [1, 1, 1] and row["epochs_run"] == 3
    assert row["rf_warmup_epochs"] == 20 and row["best_epoch"] == 0 and row["past_warmup"] is False
    assert set(row["launches"]) == {
        "segment_spmm", "segment_spmm_backward", "segment_spmm_blocked", "segment_spmm_blocked_backward",
        "grouped_topk", "candidate_extract", "masked_group_max", "fused_group_max", "fused_candidates",
        "fused_candidates_unmasked"} and not any(row["launches"].values())
    assert row["peak_allocated_bytes"] is None and row["device_name"] == "cpu"
    from genmmrec_tpu_torch.__main__ import RUN_TAG

    assert _load(os.path.join(SCRIPTS, "harness_torch.py"), "harness_torch").RUN_TAG == RUN_TAG
    ref = _jax("compare_models").parse_results(log)
    assert row["valid_recall@20"] == ref["valid"]["recall@20"] and row["test_ndcg@20"] == ref["test"]["ndcg@20"]
    assert not glob.glob(os.path.join(str(work), "saved", "*.ckpt"))


def test_parsers_match_the_jax_ones_on_a_port_log(real_child, tmp_path):
    """``parse_results``, ``parse_log_file`` and the staged search's rule on
    the real child's log, against the JAX scripts'; the log comparison and
    the report on its work directory and journal."""
    work, rows, log = real_child
    got = _port("compare_models").parse_results(log)
    assert got == _jax("compare_models").parse_results(log) and got["valid"] and got["test"]
    (path,) = glob.glob(str(work / "log" / "RFBM3-tiny-*.log"))
    cmp = _port("compare_results")
    assert cmp.parse_log_file(path) == _jax("compare_results").parse_log_file(path)
    m = re.findall(r"recall@20:\s*([\d.]+)", log)
    assert _port("run_rf_staged_search").best_of(log) == max(float(x) for x in m)
    assert cmp.main(["--workdir", str(work), "--dataset", "tiny", "--epochs", "1"]) == 0
    assert "RFBM3" in open(work / "rf_comparison_torch.csv").read()
    out = tmp_path / "report.md"
    _load(os.path.join(SCRIPTS, "harness_report_torch.py"), "harness_report_torch").main(
        ["tiny", "--journal", str(work / "j.json"), "--out", str(out)])
    assert "| RFBM3/tiny/norf | no JAX row |" in open(out).read()


def test_parse_run_reads_the_last_current_best_of_a_cut_child(real_child):
    """``parse_run`` takes its four metrics from ``parse_results``, the one
    BEST-block parser of the harnesses: from the final BEST block, or from
    the last ``Current BEST`` block of a child cut before it."""
    _, rows, log = real_child
    H = _load(os.path.join(SCRIPTS, "harness_torch.py"), "harness_torch")
    assert _port("compare_models").parse_results(log) == H.parse_results(log)
    cut = log[:log.index("█████████████ BEST")]
    assert cut.count("████Current BEST████") == 3
    for text, want in ((log, H.parse_results(log)),
                       (cut, H.parse_results(cut[cut.rindex("████Current BEST████"):]))):
        row = H.parse_run(text)
        assert [row[f"{s}_{n}"] for s in ("valid", "test") for n in ("recall@20", "ndcg@20")] == [
            want[s][n] for s in ("valid", "test") for n in ("recall@20", "ndcg@20")]
    assert all(v is None for k, v in H.parse_run("no block").items() if k.endswith("@20"))
