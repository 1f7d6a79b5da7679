"""The port's zoo sweep (``scripts/zoo_sweep_torch.py``), its report
(``scripts/zoo_report_torch.py``) and its structured generator
(``scripts/make_structured_dataset_torch.py``) on the CPU, at small size:
the BEST-block parser on a real CLI log of the port, the band rule and the
ordering checks on hand-written rows, the generator's files against the
JAX package's script, and one sweep child."""

from __future__ import annotations

import functools
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
    BEST block, the JAX sweep's pins, no kernel launched on the CPU; its
    checkpoint removed once the row is recorded."""
    _, rows, log, work = swept
    assert (work / "saved").is_dir() and not list((work / "saved").iterdir())
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
    assert epochs["valid_scores"] == [want_valid]  # one epoch: its evaluation is the BEST one


def test_parse_epochs_flags_non_finite_losses():
    ok = "epoch 0 training [time: 1.00s, train_loss1: 0.5000, train_loss2: 0.2500]\n"
    assert sweep.parse_epochs(ok)["losses_finite"] and sweep.parse_epochs(ok)["train_s"] == 1.0
    bad = ok + "epoch 1 training [time: 1.00s, train_loss1: nan, train_loss2: 0.2500]\n"
    assert not sweep.parse_epochs(bad)["losses_finite"]
    assert not sweep.parse_epochs(ok + "Loss is nan at epoch: 1. Exiting.\n")["losses_finite"]
    evals = ok + "epoch 0 evaluating [time: 0.50s, valid_score: 0.084500]\n" + ok.replace("epoch 0", "epoch 1") + (
        "epoch 1 evaluating [time: 0.50s, valid_score: 0.101500]\n")
    assert sweep.parse_epochs(evals)["valid_scores"] == [0.0845, 0.1015]


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


CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


def _row(v, ok=True, seconds=12.5):
    return {"ok": ok, "seconds": seconds, "valid_recall@20": v, "test_recall@20": v, "test_ndcg@20": v and v / 2,
            "epochs_run": 7, "card": CARD, "jobs": 1, "last_loss": "train loss: 0.1000",
            "child": {"peak_allocated_bytes": 2.5e9}}


def _write_journals(path, dataset, lanes, prefix="zoo_sweep_torch"):
    for tag, rows in lanes.items():
        with open(path / f"{prefix}_{dataset}{tag}.json", "w") as f:
            json.dump(rows, f)


def _line(text, section, model):
    part = text.split(f"## {section}", 1)[1].split("\n## ", 1)[0]
    (hit,) = [ln for ln in part.splitlines() if ln.startswith(f"| {model} |")]
    return hit


def _baby_report(tmp_path, monkeypatch):
    """Every baby lane, against the repo's JAX records: statuses, ratios and
    verdicts (in band, seed spread, open, the absolute band), the card
    beside the wall times, the orderings on the port's rows."""
    lanes = {
        "": {"BPR": _row(0.08), "LightGCN": _row(None, ok=False)},
        # BPR's JAX row 0.1555, LightGCN's 0.1550, RFMRec's 0.0016, GRCN's 0.1132
        "_converged": {"BPR": _row(0.1500), "LightGCN": _row(0.1000), "RFMRec": _row(0.0100), "GRCN": _row(0.0800)},
        "_converged_seed1000": {"LightGCN": _row(0.1450), "GRCN": _row(0.0810)},
        "_converged_seed2022": {"LightGCN": _row(0.1200), "GRCN": _row(0.0820)},
        "_struct": {"VBPR": _row(0.0500), "BPR": _row(0.0460)},
    }
    _write_journals(tmp_path, "baby", lanes)
    out = tmp_path / "doc.md"
    report.main(["baby", "--logs", str(tmp_path), "--out", str(out)])
    text = out.read_text()
    line = lambda section, model: _line(text, section, model)
    assert line("2-epoch lane", "BPR").startswith("| BPR | OK | 12.5 | 2.50 | 0.0800 | 0.0863 |")
    assert "| LightGCN | FAIL |" in line("2-epoch lane", "LightGCN")
    assert line("Converged lane", "BPR").endswith("| in band |") and "| 0.96 |" in line("Converged lane", "BPR")
    assert line("Converged lane", "LightGCN").endswith("| seed spread |")
    assert "0.1450 / 0.1200" in line("Converged lane", "LightGCN")
    assert line("Converged lane", "RFMRec").endswith("| in band |")  # 0.0084 from 0.0016
    assert line("Converged lane", "GRCN").endswith("| OPEN: outside the band |")
    assert "| pending |" in line("Converged lane", "DiffMM")
    assert line("Structured-feature lane", "VBPR").endswith("| in band |")
    assert f"Wall (s), {CARD} |" in text and "Wall (s), no card recorded" not in text.split("## Structured")[0]
    assert "| VBPR > BPR | struct | 0.0500 vs 0.0460 | ✅ | 0.0501 vs 0.0467 | ✅ |" in text
    assert "| LightGCN > BPR | conv | 0.1000 vs 0.1500 | ❌ | 0.1550 vs 0.1555 | ❌ |" in text
    assert "## 15-epoch lane" not in text and "The JAX package fails three of them" in text
    assert "TPU" not in text


def _sports_report(tmp_path, monkeypatch):
    """The sports 15-epoch lane against a hand-written JAX ``_r3`` record:
    rows in band (the absolute band too), seed spread, explained by a
    ``NOTES`` entry, pending and OPEN; the 2-epoch lane with no JAX record;
    the ordering and RF-versus-host checks only where the lane holds both
    models; no converged or structured lane; the sports findings alone."""
    jax_dir, port_dir = tmp_path / "comparison_logs", tmp_path / "port"
    jax_dir.mkdir()
    port_dir.mkdir()
    monkeypatch.setattr(report, "ROOT", str(tmp_path))  # the JAX records are read under the checkout
    jax_rows = {"BM3": 0.1472, "BPR": 0.1322, "DDRM": 0.0400, "DiffMM": 0.1471, "MGCN": 0.1435,
                "RFMRec": 0.0006, "LightGCN": 0.1319, "GUME": 0.1384, "RFGUME": 0.1383, "RFBM3": 0.1465}
    jax_r3 = {m: {"ok": True, "valid_recall@20": v, "test_recall@20": v, "test_ndcg@20": v / 2, "seconds": 99.0}
              for m, v in jax_rows.items()}
    _write_journals(jax_dir, "sports", {"_r3": jax_r3}, prefix="zoo_sweep")
    r3 = {"BM3": 0.1400, "BPR": 0.1000, "DDRM": 0.0200, "MGCN": 0.0300, "RFMRec": 0.0090, "LightGCN": 0.1300,
          "GUME": 0.1350, "RFGUME": 0.1300, "RFBM3": None}
    lanes = {
        "": {"BPR": _row(0.05), "LATTICE": _row(0.06)},
        "_r3": {m: _row(v, ok=v is not None) for m, v in r3.items()},
        "_r3_seed1000": {"BPR": _row(0.1200), "MGCN": _row(0.0310)},
        "_r3_seed2022": {"BPR": _row(0.1250), "MGCN": _row(0.0320)},
    }
    _write_journals(port_dir, "sports", lanes)
    monkeypatch.setitem(report.NOTES, ("sports", "r3", "DDRM"), "the JAX record's own")
    monkeypatch.setitem(report.FINDINGS, "sports", ["**DDRM at sports.** The evidence."])
    out = tmp_path / "doc.md"
    report.main(["sports", "--logs", str(port_dir), "--out", str(out)])
    text = out.read_text()
    line = lambda section, model: _line(text, section, model)
    assert "The JAX package has no 2-epoch record at sports." in text
    assert line("2-epoch lane", "LATTICE").startswith("| LATTICE | OK | 12.5 | 2.50 | 0.0600 | — |")
    assert "| DiffMM | pending |" in line("2-epoch lane", "DiffMM")
    assert line("15-epoch lane", "BM3").endswith("| in band |") and "| 0.95 |" in line("15-epoch lane", "BM3")
    assert line("15-epoch lane", "RFMRec").endswith("| in band |")  # 0.0084 from 0.0006
    assert line("15-epoch lane", "BPR").endswith("| seed spread |") and "0.1200 / 0.1250" in line("15-epoch lane", "BPR")
    assert line("15-epoch lane", "DDRM").endswith("| explained: the JAX record's own |")
    assert line("15-epoch lane", "MGCN").endswith("| OPEN: outside the band |")
    assert line("15-epoch lane", "DiffMM").endswith("| pending |") and "| RFBM3 | FAIL |" in text
    assert "verdicts: FAIL 1, OPEN 1, explained 1, in band 5, pending 1, seed spread 1." in text
    assert "## Converged lane" not in text and "## Structured-feature lane" not in text
    assert "`comparison_logs/zoo_sweep_sports[_r3].json`" in text and "struct" not in text
    checks = text.split("## Expected-ordering checks", 1)[1].split("\n## ", 1)[0]
    assert [ln.split(" | ")[0] for ln in checks.splitlines() if ln.startswith("| ") and "---" not in ln][1:] == [
        "| LightGCN > BPR"]
    assert "| LightGCN > BPR | r3 | 0.1300 vs 0.1000 | ✅ | 0.1319 vs 0.1322 | ❌ |" in checks
    assert "The JAX package fails one of them" in checks
    rf = text.split("## RF family vs host models", 1)[1].split("\n## ", 1)[0]
    assert "An RF variant's 15-epoch valid Recall@20" in rf
    assert "| RFGUME | GUME | 0.1300 | 0.1350 | -0.0050 | ✅ | -0.0001 | ✅ |" in rf
    assert "| RFBM3 | BM3 | — | 0.1400 | — | pending | -0.0007 | ✅ |" in rf
    assert "1/2 RF variants within the band of their host." in rf
    assert "**DDRM at sports.** The evidence." in text and "Structured BM3 and MVGAE" not in text


def _cpu_tier_report(tmp_path, monkeypatch, tier):
    """A tier whose 15-epoch JAX rows were taken on the CPU (clothing,
    microlens): the report says so and gives the JAX sweep's command; rows
    in band and OPEN; a JAX child past its timeout leaves the port's row OK
    only, named in its verdict; the tier's sizes; no 2-epoch JAX record."""
    jax_dir, port_dir = tmp_path / "comparison_logs", tmp_path / "port"
    jax_dir.mkdir()
    port_dir.mkdir()
    monkeypatch.setattr(report, "ROOT", str(tmp_path))
    jax_r3 = {m: {"ok": True, "valid_recall@20": v, "test_recall@20": v, "test_ndcg@20": v / 2, "seconds": 99.0}
              for m, v in {"BPR": 0.0500, "LightGCN": 0.0600, "VBPR": 0.0400, "FREEDOM": 0.0700}.items()}
    jax_r3["DiffMM"] = {"ok": False, "seconds": 2700, "valid_recall@20": None, "returncode": None, "tail": "TIMEOUT"}
    _write_journals(jax_dir, tier, {"_r3": jax_r3}, prefix="zoo_sweep")
    r3 = {"BPR": 0.0510, "LightGCN": 0.0300, "VBPR": 0.0420, "FREEDOM": 0.0690, "DiffMM": 0.0650}
    _write_journals(port_dir, tier, {"": {"BPR": _row(0.04)}, "_r3": {m: _row(v) for m, v in r3.items()}})
    out = tmp_path / "doc.md"
    report.main([tier, "--logs", str(port_dir), "--out", str(out)])
    text = out.read_text()
    line = lambda section, model: _line(text, section, model)
    users, items = report.TIERS[tier]
    assert f"({users:,} users × {items:,} items)" in text
    assert f"The JAX package has no 2-epoch record at {tier}." in text
    assert "**these JAX rows were taken on the CPU**" in text
    assert f"`JAX_PLATFORMS=cpu python scripts/zoo_sweep.py --dataset {tier} --tag r3 --epochs 15" in text
    assert "--timeout 1400" not in text
    assert line("15-epoch lane", "BPR").endswith("| in band |")
    assert line("15-epoch lane", "LightGCN").endswith("| OPEN: outside the band |")
    assert line("15-epoch lane", "DiffMM").endswith(
        "| OK only: the JAX child ran past its 2700 s timeout, no JAX row |")
    assert "| DiffMM | OK | 7 | 12.5 | 2.50 | 0.0650 | — | — |" in line("15-epoch lane", "DiffMM")
    assert "verdicts: OK only 1, OPEN 1, in band 3." in text
    assert "TPU" not in text


@pytest.mark.parametrize(
    "case",
    [_baby_report, _sports_report, functools.partial(_cpu_tier_report, tier="clothing"),
     functools.partial(_cpu_tier_report, tier="microlens")],
    ids=["baby", "sports", "clothing", "microlens"],
)
def test_report_on_hand_written_journals(tmp_path, monkeypatch, case):
    case(tmp_path, monkeypatch)


def test_baby_report_unchanged_by_the_sports_lane(tmp_path):
    """The committed baby journals render ``docs/ZOO_RESULTS_TORCH.md`` byte
    for byte."""
    out = tmp_path / "baby.md"
    report.main(["baby", "--out", str(out)])
    with open(os.path.join(REPO, "docs", "ZOO_RESULTS_TORCH.md"), "rb") as f:
        assert out.read_bytes() == f.read()


@pytest.mark.parametrize("tier", ["sports", "clothing", "microlens"])
def test_tier_report_unchanged(tmp_path, tier):
    """The committed journals of each tier past baby render its report,
    ``docs/ZOO_RESULTS_TORCH_<TIER>.md``, byte for byte."""
    out = tmp_path / f"{tier}.md"
    report.main([tier, "--out", str(out)])
    with open(report.default_out(tier), "rb") as f:
        assert out.read_bytes() == f.read()


@pytest.mark.parametrize(
    "dataset, name", [("baby", "ZOO_RESULTS_TORCH.md"), ("sports", "ZOO_RESULTS_TORCH_SPORTS.md"),
                      ("clothing", "ZOO_RESULTS_TORCH_CLOTHING.md"), ("microlens", "ZOO_RESULTS_TORCH_MICROLENS.md")],
)
def test_report_default_out(tmp_path, monkeypatch, dataset, name):
    """The report lands in ``docs/`` under the tier's name when no ``--out``
    is given."""
    assert report.default_out(dataset) == os.path.join(REPO, "docs", name)
    monkeypatch.setattr(report, "ROOT", str(tmp_path))
    (tmp_path / "docs").mkdir()
    (tmp_path / "comparison_logs").mkdir()
    _write_journals(tmp_path / "comparison_logs", dataset, {"": {"BPR": _row(0.05)}})
    assert report.main([dataset]) == str(tmp_path / "docs" / name)
    assert "| BPR | OK |" in (tmp_path / "docs" / name).read_text()


def test_next_model_keeps_large_planes_apart():
    """``next_model``: the first model of the queue, but never one of
    ``LARGE_PLANES`` beside another."""
    assert sweep.LARGE_PLANES == ("LATTICE", "RFLATTICE", "MVDiff")
    queue = ["LATTICE", "RFLATTICE", "BPR", "MVDiff", "VBPR"]
    assert sweep.next_model(queue, set()) == "LATTICE"
    assert sweep.next_model(queue, {"BPR"}) == "LATTICE"
    assert sweep.next_model(queue, {"MVDiff"}) == "BPR"
    assert sweep.next_model(["RFLATTICE", "MVDiff"], {"LATTICE", "VBPR"}) is None
    assert sweep.next_model([], set()) is None


def test_sweep_runs_large_planes_one_at_a_time(tmp_path, monkeypatch):
    """Five children, three at once (``run_one`` a stub that sleeps): every
    model runs once, the first three to start are LATTICE, BPR and VBPR
    (RFLATTICE and MVDiff wait for LATTICE), and no two of ``LARGE_PLANES``
    ever run together."""
    import threading
    import time

    lock, running, starts, overlaps = threading.Lock(), set(), [], []

    def stub(model, *args, **kwargs):
        with lock:
            starts.append(model)
            running.add(model)
            if len(running & set(sweep.LARGE_PLANES)) > 1:
                overlaps.append(sorted(running))
        time.sleep(0.2)
        with lock:
            running.discard(model)
        return {"ok": True, "seconds": 0.2, "valid_recall@20": 0.1, "test_recall@20": 0.1, "test_ndcg@20": 0.05}

    monkeypatch.setattr(sweep, "run_one", stub)
    models = ["LATTICE", "RFLATTICE", "MVDiff", "BPR", "VBPR"]
    rc = sweep.main(["--device", "cpu", "-d", "tiny", "--models", *models, "--jobs", "3",
                     "--out", str(tmp_path / "j.json"), "--workdir", str(tmp_path / "w")])
    assert rc == 0 and sorted(starts) == sorted(models) and not overlaps
    assert starts[:3] == ["LATTICE", "BPR", "VBPR"] and starts.index("RFLATTICE") < starts.index("MVDiff")
    with open(tmp_path / "j.json") as f:
        assert set(json.load(f)) == set(models)


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
    # nor a script of the JAX side (the experiment harnesses keep their own tables)
    jax_scripts = re.compile(
        r"^\s*(?:import|from)\s+(compare_models|compare_results|run_rf_models|run_rfgume|run_ablation_prior|"
        r"run_rf_staged_search|visualize_landscape|zoo_sweep|zoo_report|main)\b(?!_torch)", re.M)
    for name in ("zoo_sweep_torch", "zoo_report_torch", "make_structured_dataset_torch", "prep_scale_torch",
                 "harness_torch", "compare_models_torch", "compare_results_torch", "run_rf_models_torch",
                 "run_rfgume_torch", "run_ablation_prior_torch", "run_rf_staged_search_torch",
                 "visualize_landscape_torch", "harness_report_torch"):
        with open(os.path.join(SCRIPTS, f"{name}.py")) as f:
            src = f.read()
        assert not pattern.search(src), name
        assert not jax_scripts.search(src), name
        assert "genmmrec_tpu." not in src.replace("genmmrec_tpu_torch", ""), name
    assert sweep.ALL_MODELS == _script("zoo_sweep").ALL_MODELS and len(set(sweep.ALL_MODELS)) == 50
