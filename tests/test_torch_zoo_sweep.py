"""The port's zoo sweep (``scripts/zoo_sweep_torch.py``), its report
(``scripts/zoo_report_torch.py``) and its structured generator
(``scripts/make_structured_dataset_torch.py``) on the CPU, at small size:
the BEST-block parser on a real CLI log of the port, the band rule and the
ordering checks on hand-written rows, the generator's files against the
JAX package's script, and one sweep child."""

from __future__ import annotations

import glob
import importlib.util
import json
import math
import os
import re
import runpy
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")


def _script(name):
    spec = importlib.util.spec_from_file_location(f"{name}_under_test", os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


sweep = _script("zoo_sweep_torch")
report = _script("zoo_report_torch")


@pytest.fixture(scope="module")
def swept(tmp_path_factory):
    """One sweep of BPR on tiny, one epoch on the CPU, in a child process:
    (journal path, the journal, the child's CLI log, the working directory)."""
    work = tmp_path_factory.mktemp("zoo")
    journal = str(work / "zoo_sweep_torch_tiny.json")
    run = subprocess.run(
        [sys.executable, os.path.join(SCRIPTS, "zoo_sweep_torch.py"), "--device", "cpu", "-d", "tiny", "--epochs", "1",
         "--models", "BPR", "--out", journal, "--workdir", str(work)],
        capture_output=True, text=True, timeout=300,
    )
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    with open(journal) as f:
        rows = json.load(f)
    (log,) = glob.glob(str(work / "log" / "BPR-tiny-*.log"))
    with open(log, encoding="utf-8") as f:
        return journal, rows, f.read(), work


def test_sweep_child_on_the_cpu(swept):
    """The row of one child: OK, one epoch, finite values equal to its log's
    BEST block, the JAX sweep's pins, no kernel launched on the CPU."""
    _, rows, log, _ = swept
    row = rows["BPR"]
    assert row["ok"] and row["returncode"] == 0 and row["tail"] == ""
    assert row["epochs_run"] == 1 and row["evals_run"] == 1 and row["losses_finite"]
    assert row["epochs_budget"] == 1 and row["card"] == "cpu" and row["jobs"] == 1
    assert row["config"] == {"hyper_parameters": ["seed"], "save_recommended_topk": False}
    for key in ("valid_recall@20", "test_recall@20", "test_ndcg@20"):
        assert math.isfinite(row[key]) and 0.0 <= row[key] <= 1.0
    assert (row["valid_recall@20"], row["test_recall@20"], row["test_ndcg@20"]) == sweep.parse_best(log)
    child = row["child"]
    assert set(child["launches"]) == set(sweep_kernels()) and not any(child["launches"].values())
    assert child["peak_allocated_bytes"] is None
    assert 0.0 < child["import_s"] <= child["setup_s"] <= child["total_s"] and child["fit_s"] > 0.0


def sweep_kernels():
    return ("segment_spmm", "segment_spmm_backward", "segment_spmm_blocked", "segment_spmm_blocked_backward",
            "grouped_topk", "candidate_extract", "masked_group_max", "fused_group_max", "fused_candidates",
            "fused_candidates_unmasked")


def test_sweep_journal_resumes(swept, capsys):
    """A second sweep over the same journal skips the OK row and leaves it."""
    journal, rows, _, work = swept
    rc = sweep.main(["--device", "cpu", "-d", "tiny", "--epochs", "1", "--models", "BPR", "--out", journal,
                     "--workdir", str(work)])
    assert rc == 0 and "BPR: cached OK" in capsys.readouterr().out
    with open(journal) as f:
        assert json.load(f) == rows


def test_parse_best_on_a_port_log(swept):
    """The final BEST block's Valid and Test sections of a real CLI log of
    the port, each value the one its section prints; a mid-run ``valid
    result`` or a group's ``Pop_Recall@20`` is never taken; a log cut before
    the BEST block parses to nothing."""
    _, _, log, _ = swept
    best = log[log.rfind("BEST"):]
    valid_part, test_part = best.split("Test:", 1)
    want_valid = float(re.search(r"\brecall@20: ([0-9.]+)", valid_part).group(1))
    want_test = float(re.search(r"(?<![A-Za-z_])recall@20: ([0-9.]+)", test_part).group(1))
    want_ndcg = float(re.search(r"(?<![A-Za-z_])ndcg@20: ([0-9.]+)", test_part).group(1))
    assert sweep.parse_best(log) == (want_valid, want_test, want_ndcg)
    assert "Pop_Recall@20" in test_part or "Pop_Recall@20" not in log
    # a decoy before the block, and a group metric first in the Test section
    decoy = "valid result: \nrecall@20: 0.9999    \n" + log
    assert sweep.parse_best(decoy) == (want_valid, want_test, want_ndcg)
    head, tail = log.rsplit("Test:", 1)
    assert sweep.parse_best(head + "Test: Pop_Recall@20: 0.7777    Pop_NDCG@20: 0.6666    " + tail) == (
        want_valid, want_test, want_ndcg)
    assert sweep.parse_best(log[: log.find("BEST")]) == (None, None, None)
    assert sweep.parse_best("epoch 0 training [time: 0.10s, train loss: 0.6931]\n") == (None, None, None)
    epochs = sweep.parse_epochs(log)
    assert epochs["epochs_run"] == 1 and epochs["evals_run"] == 1 and epochs["losses_finite"]


def test_parse_epochs_flags_non_finite_losses():
    ok = "epoch 0 training [time: 1.00s, train_loss1: 0.5000, train_loss2: 0.2500]\n"
    assert sweep.parse_epochs(ok)["losses_finite"] and sweep.parse_epochs(ok)["train_s"] == 1.0
    bad = ok + "epoch 1 training [time: 1.00s, train_loss1: nan, train_loss2: 0.2500]\n"
    assert not sweep.parse_epochs(bad)["losses_finite"]
    assert not sweep.parse_epochs(ok + "Loss is nan at epoch: 1. Exiting.\n")["losses_finite"]


@pytest.mark.parametrize(
    "port, ref, want",
    [
        (0.1600, 0.2000, True), (0.1599, 0.2000, False), (0.2500, 0.2000, True), (0.2501, 0.2000, False),
        # below the floor the band is absolute: RFMRec's and ItemKNNCBF's rows
        (0.0116, 0.0016, True), (0.0117, 0.0016, False), (0.0, 0.0029, True), (0.0129, 0.0029, True),
        (0.0130, 0.0029, False),
        (0.0080, 0.0100, True), (0.0079, 0.0100, False),
    ],
)
def test_band_rule(port, ref, want):
    assert report.in_band(port, ref) is want


def test_three_seed_rule_and_verdicts():
    assert report.seed_spread([0.12, 0.14, 0.13], 0.15) and not report.seed_spread([0.12, 0.14, 0.13], 0.1501)
    assert report.seed_spread([0.12, 0.14, 0.13], 0.11) and not report.seed_spread([0.12, 0.14, 0.13], 0.1099)
    assert report.verdict(0.17, 0.17) == "in band"
    assert report.verdict(0.12, 0.155, [0.12, 0.14, 0.148]) == "seed spread"
    assert report.verdict(0.12, 0.155, [0.12, 0.121, 0.122]) == "OPEN: outside the band"
    assert report.verdict(0.12, 0.155, [0.12, 0.14]) == "OPEN: outside the band"  # a seed still missing
    assert report.verdict(0.12, 0.155, None, "the reference's own") == "explained: the reference's own"
    assert report.verdict(None, 0.155) == "pending" and report.verdict(0.12, None) == "no JAX row"


def test_ordering_and_rf_checks_on_hand_written_rows():
    conv = {"LightGCN": 0.150, "BPR": 0.155, "LayerGCN": 0.173, "RFLayerGCN_remove": 0.160, "LGMRec": 0.178,
            "RFLightGCN_remove": 0.170, "RFBPR_remove": 0.160, "GUME": 0.169, "RFGUME": 0.158}
    struct = {"VBPR": 0.050, "BPR": 0.047, "FREEDOM": 0.050, "BM3": 0.050}

    def get(model, lane):
        return (conv if lane == "conv" else struct).get(model)

    rows = {text: ok for text, _, _, _, ok in report.ordering_rows(get)}
    assert rows["LightGCN > BPR"] is False and rows["LayerGCN > BPR"] is True
    assert rows["FREEDOM > BM3"] is False  # a tie is not a win without headroom
    assert rows["RFLayerGCN_remove ≈ LayerGCN (±10%)"] is True  # 0.160 within 10% of 0.173
    assert rows["RFLightGCN_remove ≈ LightGCN (±10%)"] is False  # 0.170 past 10% of 0.150
    assert rows["RFBPR_remove ≈ BPR (±10%)"] is True
    rf = {variant: (va, vb, ok) for variant, _, va, vb, ok in report.rf_rows(get)}
    assert rf["RFGUME"] == (0.158, 0.169, False)  # 0.011 below the host
    assert rf["RFBM3"] == (None, None, None)


def test_report_on_hand_written_journals(tmp_path):
    """The report from journals of every lane: statuses, ratios and
    verdicts (in band, seed spread, open, the absolute band), the card
    beside the wall times, the orderings on the port's rows."""
    card = "NVIDIA H100 80GB HBM3, 700.00 W"

    def row(v, ok=True, seconds=12.5):
        return {"ok": ok, "seconds": seconds, "valid_recall@20": v, "test_recall@20": v, "test_ndcg@20": v and v / 2,
                "epochs_run": 7, "card": card, "jobs": 1, "last_loss": "train loss: 0.1000",
                "child": {"peak_allocated_bytes": 2.5e9}}

    lanes = {
        "": {"BPR": row(0.08), "LightGCN": row(None, ok=False)},
        # BPR's JAX row 0.1555, LightGCN's 0.1550, RFMRec's 0.0016, GRCN's 0.1132
        "_converged": {"BPR": row(0.1500), "LightGCN": row(0.1000), "RFMRec": row(0.0100), "GRCN": row(0.0800)},
        "_converged_seed1000": {"LightGCN": row(0.1450), "GRCN": row(0.0810)},
        "_converged_seed2022": {"LightGCN": row(0.1200), "GRCN": row(0.0820)},
        "_struct": {"VBPR": row(0.0500), "BPR": row(0.0460)},
    }
    for tag, rows in lanes.items():
        with open(tmp_path / f"zoo_sweep_torch_baby{tag}.json", "w") as f:
            json.dump(rows, f)
    out = tmp_path / "doc.md"
    report.main(["baby", "--logs", str(tmp_path), "--out", str(out)])
    text = out.read_text()

    def line(section, model):
        part = text.split(f"## {section}", 1)[1].split("\n## ", 1)[0]
        (hit,) = [ln for ln in part.splitlines() if ln.startswith(f"| {model} |")]
        return hit

    assert line("2-epoch lane", "BPR").startswith("| BPR | OK | 12.5 | 2.50 | 0.0800 | 0.0863 |")
    assert "| LightGCN | FAIL |" in line("2-epoch lane", "LightGCN")
    assert line("Converged lane", "BPR").endswith("| in band |") and "| 0.96 |" in line("Converged lane", "BPR")
    assert line("Converged lane", "LightGCN").endswith("| seed spread |")
    assert "0.1450 / 0.1200" in line("Converged lane", "LightGCN")
    assert line("Converged lane", "RFMRec").endswith("| in band |")  # 0.0084 from 0.0016
    assert line("Converged lane", "GRCN").endswith("| OPEN: outside the band |")
    assert "| pending |" in line("Converged lane", "DiffMM")
    assert line("Structured-feature lane", "VBPR").endswith("| in band |")
    assert f"Wall (s), {card} |" in text and "Wall (s), no card recorded" not in text.split("## Structured")[0]
    assert "| VBPR > BPR | struct | 0.0500 vs 0.0460 | ✅ | 0.0501 vs 0.0467 | ✅ |" in text
    assert "| LightGCN > BPR | conv | 0.1000 vs 0.1500 | ❌ | 0.1550 vs 0.1555 | ❌ |" in text
    assert "TPU" not in text


def _same_graph(g, ref):
    """Equal by sorted counts and by the neighbours strictly above each
    row's least count: the JAX top-k orders and cuts ties its own way."""
    assert sorted(g) == sorted(ref)
    for u in ref:
        (n, w), (rn, rw) = g[u], ref[u]
        assert sorted(w) == sorted(rw), u
        if w:
            assert {a for a, b in zip(n, w) if b > min(w)} == {a for a, b in zip(rn, rw) if b > min(rw)}, u


def test_structured_generator_against_the_jax_script(tmp_path, monkeypatch):
    """The port's generator and the JAX package's script at a small size:
    the ``.inter`` and ``.npy`` files byte-equal, the user graphs equal."""
    size = ["--n-users", "200", "--n-items", "100", "--v-dim", "16", "--t-dim", "8", "--uu-topk", "20"]
    monkeypatch.setattr(sys, "argv", ["make_structured_dataset.py", "--out", str(tmp_path / "j"), *size])
    runpy.run_path(os.path.join(SCRIPTS, "make_structured_dataset.py"), run_name="__main__")
    _script("make_structured_dataset_torch").main(["--out", str(tmp_path / "t"), *size, "--device", "cpu"])
    for name in ("baby.inter", "image_feat.npy", "text_feat.npy"):
        assert (tmp_path / "j" / name).read_bytes() == (tmp_path / "t" / name).read_bytes(), name
    load = lambda d: np.load(tmp_path / d / "user_graph_dict.npy", allow_pickle=True).item()
    j, t = load("j"), load("t")
    assert len(t) == 200 and max(len(t[u][0]) for u in t) == 20
    _same_graph(t, j)


def test_scripts_import_neither_jax_nor_the_jax_package():
    pattern = re.compile(r"^\s*(?:import|from)\s+(jax|genmmrec_tpu)\b(?!_torch)", re.M)
    for name in ("zoo_sweep_torch", "zoo_report_torch", "make_structured_dataset_torch"):
        with open(os.path.join(SCRIPTS, f"{name}.py")) as f:
            src = f.read()
        assert not pattern.search(src), name
        assert "genmmrec_tpu." not in src.replace("genmmrec_tpu_torch", ""), name
    assert sweep.ALL_MODELS == _script("zoo_sweep").ALL_MODELS and len(set(sweep.ALL_MODELS)) == 50
