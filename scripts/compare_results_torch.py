#!/usr/bin/env python
"""RF-enhancement results comparison of the PyTorch/CUDA port's logs
(counterpart of ``compare_results.py``): regex-extract ``recall@K`` /
``ndcg@K`` / ``precision@K`` / ``map@K`` (the best value a log shows) from
the port's run logs and print a base-vs-RF table with each RF model's
deltas against its base. It reads the logs the harnesses' children wrote
in their work directory (``<workdir>/log``) and writes
``<workdir>/rf_comparison_torch.csv``; it needs no pandas. Options it does
not know (a harness's ``--epochs``, ``--device``) are ignored, so that one
argument list serves a harness and this report.

Usage:
    python scripts/compare_results_torch.py --pairs GUME:<workdir>/log/GUME-baby-*.log RFGUME:<workdir>/log/RFGUME-baby-*.log
    python scripts/compare_results_torch.py [--workdir DIR] [--log-dir DIR] --dataset baby
"""

from __future__ import annotations

import argparse
import csv
import glob
import os
import re
import sys
from typing import Dict

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import harness_torch as H  # noqa: E402  (same directory)

METRIC_PATTERNS = {
    name: rf"{name}\s*:\s*([\d.]+)"
    for name in [
        "recall@5", "recall@10", "recall@20", "recall@50",
        "ndcg@5", "ndcg@10", "ndcg@20", "ndcg@50",
        "precision@5", "precision@10", "precision@20",
        "map@10", "map@20",
    ]
}


def parse_log_file(log_file: str) -> Dict[str, float]:
    metrics: Dict[str, float] = {}
    if not os.path.exists(log_file):
        print(f"Warning: log file not found: {log_file}")
        return metrics
    content = open(log_file, "r", errors="ignore").read()
    for name, pattern in METRIC_PATTERNS.items():
        matches = re.findall(pattern, content, re.IGNORECASE)
        if matches:
            metrics[name] = max(float(m) for m in matches)
    return metrics


def comparison_rows(entries: Dict[str, Dict[str, float]]) -> Dict[str, Dict[str, float]]:
    """The entries, then ``<RF model> Δ%`` rows: each metric's change in
    percent against the base model (the name without ``RF``), rounded to 2
    places, where both are present."""
    rows = dict(entries)
    for name in list(entries):
        base = entries.get(name[2:]) if name.startswith("RF") else None
        if base:
            rows[f"{name} Δ%"] = {k: round((v - base[k]) / base[k] * 100.0, 2)
                                  for k, v in entries[name].items() if base.get(k)}
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", nargs="*", default=[], help="NAME:logglob entries")
    ap.add_argument("--log-dir", default=None, help="default <workdir>/log")
    ap.add_argument("--workdir", default=H.WORKDIR)
    ap.add_argument("--dataset", default="baby")
    args, _ = ap.parse_known_args(argv)
    log_dir = args.log_dir or os.path.join(args.workdir, "log")

    entries = {}
    for pair in args.pairs:
        name, pattern = pair.split(":", 1)
        files = sorted(glob.glob(pattern))
        if files:
            entries[name] = parse_log_file(files[-1])
    if not entries:
        for f in sorted(glob.glob(os.path.join(log_dir, f"*-{args.dataset}-*.log"))):
            name = os.path.basename(f).split("-")[0]
            entries[name] = parse_log_file(f)

    if not entries:
        print("Nothing to compare.")
        return 1

    rows = comparison_rows(entries)
    names = list(METRIC_PATTERNS)
    print(f"{'':>20}" + "".join(f"{n:>14}" for n in names))
    for name, m in rows.items():
        print(f"{name:>20}" + "".join(f"{m[n]:>14.4f}" if n in m else f"{'':>14}" for n in names))
    os.makedirs(args.workdir, exist_ok=True)
    out = os.path.join(args.workdir, "rf_comparison_torch.csv")
    with open(out, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow([""] + names)
        for name, m in rows.items():
            w.writerow([name] + [m.get(n, "") for n in names])
    print(f"\nSaved {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
