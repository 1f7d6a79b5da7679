#!/usr/bin/env python
"""Render the journal of the port's experiment harnesses at one dataset
(``comparison_logs/harness_torch_<ds>.json``, written by
``scripts/run_harnesses_torch.sh <ds>``) as ``docs/HARNESS_RESULTS_TORCH.md``
(baby) or ``docs/HARNESS_RESULTS_TORCH_<DS>.md``, each row held against the
JAX package's record.

The journal's rows (``scripts/harness_torch.py``):
  * ``RFBM3/<ds>/rf`` and ``/norf``      — ``scripts/run_rf_comparison_torch.sh <ds> RFBM3 --epochs 50``
  * ``DiffMM``, ``RFMRec``               — ``scripts/run_comparison_torch.sh <ds>``
  * ``RFGUME/<ds>/<ablation>``           — ``scripts/run_ablation_prior_torch.py --dataset <ds>``
  * ``RFGUME/<ds>/stage<s>[/<key>=<v>]`` — ``scripts/run_rf_staged_search_torch.py --dataset <ds> --epochs 5``
  * ``landscape/<model>/<ds>``           — ``scripts/visualize_landscape_torch.py --against-plain``

The JAX records, read as JSON data only: ``our_runs/RFBM3-<ds>-{rf,norf}/result.json``
(50 epochs) for the RF comparison, and the converged zoo rows
``comparison_logs/zoo_sweep_<ds>_converged.json`` for DiffMM, RFMRec and
the ablation's ``both`` (``run_rfgume.py``'s baby overrides equal the
YAML). Their wall times were taken on another device and are not carried
over.

Each metric is held by the zoo report's rule (``zoo_report_torch.verdict``):
the 0.8–1.25× band (an absolute 0.01 below 0.01), then the three-seed rule
where seed rows exist, then an entry of ``NOTES``. Each RF row gives its
best epoch against ``rf_warmup_epochs``: before it the generated
embeddings reach no score, so rows that differ only in the flow's settings
evaluate the same host and equal rows are the expected result.

Usage:
    python scripts/harness_report_torch.py [baby] [--journal PATH] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from zoo_report_torch import verdict  # noqa: E402  (same directory)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ABLATIONS = ("baseline", "user_only", "cosine_only", "both")
METRICS = ("valid_recall@20", "valid_ndcg@20", "test_recall@20", "test_ndcg@20")
# what explains a metric outside the band, by (row key, metric)
NOTES: dict[tuple[str, str], str] = {}


def _load(path):
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def jax_rf_record(dataset: str, flag: str) -> dict:
    """The four metrics of ``our_runs/RFBM3-<ds>-<flag>/result.json``."""
    r = _load(os.path.join(ROOT, "our_runs", f"RFBM3-{dataset}-{flag}", "result.json"))
    if not r:
        return {}
    v, t = r["best_valid"], r["test_upon_valid"]
    return {"valid_recall@20": float(v["recall@20"]), "valid_ndcg@20": float(v["ndcg@20"]),
            "test_recall@20": float(t["recall@20"]), "test_ndcg@20": float(t["ndcg@20"])}


def jax_rf_log(dataset: str, flag: str) -> tuple[list, list]:
    """(valid Recall@20 by epoch, the host's loss by epoch) of the JAX
    record's log ``our_runs/RFBM3-<ds>-<flag>/stdout.log``."""
    path = os.path.join(ROOT, "our_runs", f"RFBM3-{dataset}-{flag}", "stdout.log")
    if not os.path.exists(path):
        return [], []
    text = open(path, errors="ignore").read()
    scores = [float(v) for v in re.findall(r"valid_score: ([0-9.]+)", text)]
    losses = [float(v) for v in re.findall(r"training \[time: [0-9.]+s, train[ _]loss1?: ([0-9.]+)", text)]
    return scores, losses


def jax_zoo_record(dataset: str, model: str) -> dict:
    """The converged zoo row's metrics (it keeps no valid NDCG@20)."""
    r = _load(os.path.join(ROOT, "comparison_logs", f"zoo_sweep_{dataset}_converged.json")).get(model) or {}
    return {k: r.get(k) for k in ("valid_recall@20", "test_recall@20", "test_ndcg@20")}


def fmt(v, digits=4):
    return "—" if v is None else f"{v:.{digits}f}"


def held(key: str, row: dict, ref: dict) -> tuple[list, str]:
    """(cells of each metric: the port's value, the JAX one and the
    verdict; the row's verdict: the worst of them)."""
    cells, verdicts = [], []
    for m in METRICS:
        port, jax = row.get(m), ref.get(m)
        v = verdict(port, jax, note=NOTES.get((key, m))) if row.get("ok") else "FAIL"
        verdicts.append(v)
        cells.append(f"{fmt(port)} / {fmt(jax)}" + ("" if v in ("in band", "no JAX row") else f" ({v})"))
    order = ["FAIL", "OPEN: outside the band", "pending"]
    worst = next((v for v in order if v in verdicts), None)
    worst = worst or next((v for v in verdicts if v.startswith("explained")), None) or (
        "in band" if "in band" in verdicts else verdicts[0])
    return cells, worst


def warm(row: dict) -> str:
    if row.get("best_epoch") is None:
        return "—"
    side = "past" if row.get("past_warmup") else "before"
    return f"{row['best_epoch']} ({side} {row.get('rf_warmup_epochs')})"


def _gb(row):
    b = row.get("peak_allocated_bytes")
    return "—" if b is None else f"{b / 1e9:.2f}"


def _kernels(row):
    la = row.get("launches") or {}
    return ", ".join(f"{k} {v}" for k, v in la.items() if v) or "none"


def details(lines, key, row):
    """The row's run: wall, peak memory, launches, each combination's best
    epoch and per-epoch valid Recall@20."""
    lines.append(f"- `{key}` [{row.get('card')}; {row.get('concurrent', 1)} harnesses at once]: "
                 f"{'OK' if row.get('ok') else 'FAIL'}, {row.get('seconds')} s wall, "
                 f"peak allocated {_gb(row)} GB, {row.get('epochs_run')} epochs ({row.get('train_s')} s training); "
                 f"launches: {_kernels(row)}.")
    for c in row.get("combinations") or []:
        scores = ", ".join(fmt(v) for v in c["valid_scores"])
        lines.append(f"  - `{c['parameters']}`: best epoch {c['best_epoch']} of {c['epochs_run']}, valid "
                     f"Recall@20 by epoch: {scores}")


def main(argv=None) -> str:
    ap = argparse.ArgumentParser()
    ap.add_argument("dataset", nargs="?", default="baby")
    ap.add_argument("--journal", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    ds = args.dataset
    journal = args.journal or os.path.join(ROOT, "comparison_logs", f"harness_torch_{ds}.json")
    out = args.out or os.path.join(ROOT, "docs", "HARNESS_RESULTS_TORCH" + ("" if ds == "baby" else f"_{ds.upper()}") + ".md")
    rows = _load(journal)
    cards = sorted({r["card"] for r in rows.values() if isinstance(r, dict) and r.get("card")})
    lines = [
        f"# The port's experiment harnesses at {ds} (genmmrec_tpu_torch)",
        "",
        f"Rendered by `scripts/harness_report_torch.py` from `{os.path.relpath(journal, ROOT)}`. Card: "
        f"{'; '.join(cards) or '—'}. Each cell is the port's value / the JAX record's; a verdict other than "
        "in band stands beside its cell. Times and memory are the card's, with the runs sharing it as the "
        "journal's rows say (`concurrent`); the JAX records' wall times were taken on a TPU and are not compared.",
        "",
        "## The RF comparison (`run_rf_comparison_torch.sh`), RFBM3 against `our_runs/RFBM3-<ds>-{rf,norf}`",
        "",
        "| row | verdict | best grid point | best epoch (warm-up) | valid R@20 | valid N@20 | test R@20 | test N@20 |",
        "|---|---|---|---|---|---|---|---|",
    ]
    order = []
    for flag in ("rf", "norf"):
        key = f"RFBM3/{ds}/{flag}"
        if key in rows:
            cells, v = held(key, rows[key], jax_rf_record(ds, flag))
            lines.append(f"| {key} | {v} | `{rows[key].get('best_parameters')}` | {warm(rows[key])} | " + " | ".join(cells)
                         + " |")
            order.append(key)
    rf, norf = rows.get(f"RFBM3/{ds}/rf"), rows.get(f"RFBM3/{ds}/norf")
    if rf and norf:
        j_rf, j_rf_loss = jax_rf_log(ds, "rf")
        j_norf, j_norf_loss = jax_rf_log(ds, "norf")
        warmup = rf.get("rf_warmup_epochs") or 0
        cut = min(len(rf["combinations"][0]["valid_scores"]), len(norf["combinations"][0]["valid_scores"]), warmup)
        scores = lambda r: r["combinations"][0]["valid_scores"]
        host_gap = max((abs(a - b) / b for a, b in zip(j_rf_loss, j_norf_loss)), default=float("nan"))
        lines += [
            "",
            f"**rf against norf before the warm-up.** Both rows' best epoch is before `rf_warmup_epochs` = {warmup}, "
            "where the flow's term is multiplied by 0, yet the rf row's valid Recall@20 falls from epoch ~6 while the "
            f"norf row's stays: at epoch {cut - 1} the port gives {fmt(scores(rf)[cut - 1])} (rf) against "
            f"{fmt(scores(norf)[cut - 1])} (norf). The JAX records do the same (rf "
            f"{', '.join(fmt(v) for v in j_rf)} by epoch; norf {', '.join(fmt(v) for v in j_norf[:len(j_rf)])}), "
            f"with the host's loss the same in every epoch of the two runs (at most {host_gap:.1e} apart, "
            "relative; `our_runs/RFBM3-<ds>-{rf,norf}/stdout.log`). The cause is the evaluation, in both packages: with "
            "`use_rf` the host mixin scores `rf_host_repr`, BM3's propagated embeddings without its predictor "
            "(`genmmrec_tpu/models/rf_host.py` `full_embeddings`, `genmmrec_tpu_torch/models/rf_host.py`), while "
            "BM3 itself scores them through the predictor. The port reproduces the JAX package here; past the "
            "warm-up its rf grid points part by `rf_loss_weight` (epoch "
            f"{warmup}: {', '.join(fmt(c['valid_scores'][warmup]) for c in rf['combinations'] if len(c['valid_scores']) > warmup)}).",
        ]
    lines += ["", "## DiffMM against RFMRec (`run_comparison_torch.sh`), against the JAX converged zoo rows", "",
              "| row | verdict | best epoch | valid R@20 | valid N@20 | test R@20 | test N@20 |", "|---|---|---|---|---|---|---|"]
    for model in ("DiffMM", "RFMRec"):
        if model in rows:
            cells, v = held(model, rows[model], jax_zoo_record(ds, model))
            lines.append(f"| {model} | {v} | {rows[model].get('best_epoch')} | " + " | ".join(cells) + " |")
            order.append(model)
    lines += ["", "## RFGUME's prior-guidance ablation (`run_ablation_prior_torch.py`); `both` against the JAX "
              "converged RFGUME row", "",
              "| setting | verdict | best grid point | best epoch (warm-up) | valid R@20 | valid N@20 | test R@20 | test N@20 |",
              "|---|---|---|---|---|---|---|---|"]
    for name in ABLATIONS:
        key = f"RFGUME/{ds}/{name}"
        if key in rows:
            ref = jax_zoo_record(ds, "RFGUME") if name == "both" else {}
            cells, v = held(key, rows[key], ref)
            lines.append(f"| {name} | {v} | `{rows[key].get('best_parameters')}` | {warm(rows[key])} | "
                         + " | ".join(cells) + " |")
            order.append(key)
    abl = [rows[f"RFGUME/{ds}/{a}"] for a in ABLATIONS if f"RFGUME/{ds}/{a}" in rows]
    if len(abl) == len(ABLATIONS):
        warmup = abl[0].get("rf_warmup_epochs") or 0
        traj = [[c["valid_scores"] for c in r["combinations"]] for r in abl]
        before = all(v[:warmup] == ref[:warmup] for x in traj for v, ref in zip(x, traj[0]))
        after = max((abs(a - b) for x in traj for va, vb in zip(x, traj[0]) for a, b in zip(va[warmup:], vb[warmup:])),
                    default=0.0)
        lines += ["", f"The four settings' valid Recall@20 {'are equal in every epoch' if before else 'differ'} before "
                  f"epoch {warmup} (the guidance shapes the flow alone, whose term reaches no score before the warm-up) "
                  f"and differ by at most {after:.4f} after it; every best epoch is before {warmup}, so equal rows are "
                  "the expected result."]
    lines += ["", "## The staged search (`run_rf_staged_search_torch.py --epochs 5`), RFGUME", "",
              "| stage | key | value | largest recall@20 | best epoch (warm-up) | picked |", "|---|---|---|---|---|---|"]
    state = None
    for stage in (1, 2, 3):
        pick = rows.get(f"RFGUME/{ds}/stage{stage}")
        for key in sorted(k for k in rows if k.startswith(f"RFGUME/{ds}/stage{stage}/")):
            r = rows[key]
            name, value = key.rsplit("/", 1)[1].split("=")
            picked = pick is not None and str(pick["best"]) == value
            lines.append(f"| {stage} | {name} | {value} | {fmt(r.get('largest_recall20'))} | {warm(r)} | "
                         f"{'yes' if picked else ''} |")
            order.append(key)
        if pick:
            state = pick["state"]
    if state is not None:
        lines += ["", f"The state file after the last stage (`rf_staged_search_state_torch.json`): `{json.dumps(state)}`."]
    lines += ["", "## The loss landscape (`visualize_landscape_torch.py --against-plain`)", "",
              "| checkpoint | steps | distance | loss at checkpoint | grid s | K1 launches | plain grid s | "
              "kernel launches on the plain grid | largest difference from the plain grid | card |",
              "|---|---|---|---|---|---|---|---|---|---|"]
    for key in sorted(k for k in rows if k.startswith("landscape/")):
        r = rows[key]
        lines.append(f"| {key.split('/', 1)[1]} | {r['steps']} | {r['distance']} | {r['loss_at_checkpoint']:.6f} | "
                     f"{r['grid_s']:.2f} | {r['launches'].get('segment_spmm')} | {fmt(r.get('plain_grid_s'), 2)} | "
                     f"{sum(r['plain_launches'].values()) if 'plain_launches' in r else ''} | "
                     f"{r.get('max_abs_diff_to_plain', float('nan')):.3g} | {r.get('card')} |")
    lines += ["", "## Each run", ""]
    for key in order:
        details(lines, key, rows[key])
    lines.append("")
    text = "\n".join(lines)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        f.write(text)
    print(f"wrote {out}")
    return text


if __name__ == "__main__":
    main()
