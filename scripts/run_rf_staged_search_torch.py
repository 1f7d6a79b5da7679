#!/usr/bin/env python3
"""Staged RF hyper-parameter search of the PyTorch/CUDA port (3+3+3 instead
of 3×3×3; counterpart of ``scripts/run_rf_staged_search.py``):

  stage 1: search rf_loss_weight             {0.2, 0.4, 0.6}
  stage 2: fix best, search rf_learning_rate {1e-4, 3e-4, 1e-3}
  stage 3: fix both, search rf_inference_mix_ratio {0.02, 0.05, 0.1}

Each value is one ``python -m genmmrec_tpu_torch`` child (``hyper_parameters:
[]``, so that it runs one combination), on the card unless ``--device cpu``
is given, in the harnesses' work directory (``harness_torch.py``). A
stage keeps the value whose child printed the largest ``recall@20:``;
the values kept are persisted to ``<workdir>/rf_staged_search_state_torch.json``
(the JAX package's ``rf_staged_search_state.json`` is not touched). With
``--journal`` each child's row is recorded under
``<model>/<dataset>/stage<s>/<key>=<value>``, and each stage's pick and the
state after it under ``<model>/<dataset>/stage<s>``.

Usage: python scripts/run_rf_staged_search_torch.py --dataset baby --models RFGUME [--stage all|1|2|3] [--epochs N]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import harness_torch as H  # noqa: E402  (same directory)

STATE_NAME = "rf_staged_search_state_torch.json"

STAGES = {
    1: ("rf_loss_weight", [0.2, 0.4, 0.6]),
    2: ("rf_learning_rate", [1e-4, 3e-4, 1e-3]),
    3: ("rf_inference_mix_ratio", [0.02, 0.05, 0.1]),
}


def state_file(workdir: str) -> str:
    return os.path.join(workdir, STATE_NAME)


def _load_state(workdir):
    path = state_file(workdir)
    return json.load(open(path)) if os.path.exists(path) else {}


def _save_state(workdir, s):
    os.makedirs(workdir, exist_ok=True)
    json.dump(s, open(state_file(workdir), "w"), indent=2)


def best_of(output: str) -> float:
    """The largest ``recall@20:`` a child printed (0 when none)."""
    m = re.findall(r"recall@20:\s*([\d.]+)", output)
    return max((float(x) for x in m), default=0.0)


def run_stage(model, dataset, stage, epochs=None, device="cuda", workdir=H.WORKDIR, journal=None, info=None,
              timeout=None):
    key, values = STAGES[stage]
    state = _load_state(workdir)
    fixed = state.get(f"{model}:{dataset}", {})
    results = {}
    for v in values:
        overrides = {**fixed, key: v, "hyper_parameters": []}
        path = H.write_overrides(overrides, "rf_stage_overrides_")
        cmd = H.child_command(model, dataset, path, device, epochs)
        print(f"[stage {stage}] {model} {key}={v}", flush=True)
        try:
            rc, out, seconds = H.run_child(cmd, workdir, timeout)
        finally:
            os.unlink(path)
        results[v] = best_of(out)
        row = H.row_of(cmd, rc, out, seconds, info, harness="run_rf_staged_search_torch", dataset=dataset,
                       overrides=overrides, stage=stage, largest_recall20=results[v])
        H.record(journal, f"{model}/{dataset}/stage{stage}/{key}={v}", row)
        if not row["ok"]:
            print(row["tail"], flush=True)
    best_v = max(results, key=results.get)
    print(f"[stage {stage}] best {key}={best_v} (recall@20={results[best_v]:.4f})", flush=True)
    fixed[key] = best_v
    state[f"{model}:{dataset}"] = fixed
    _save_state(workdir, state)
    H.record(journal, f"{model}/{dataset}/stage{stage}", {"key": key, "largest_recall20": results, "best": best_v,
                                                         "state": state})
    return best_v, results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="baby")
    ap.add_argument("--models", nargs="+", default=["RFGUME"])
    ap.add_argument("--stage", default="all")
    H.add_common_args(ap)
    args = ap.parse_args(argv)
    stages = [1, 2, 3] if args.stage == "all" else [int(args.stage)]
    info = H.run_info(args)
    for model in args.models:
        for st in stages:
            run_stage(model, args.dataset, st, args.epochs, args.device, args.workdir, args.journal, info,
                      args.timeout)
    print(json.dumps(_load_state(args.workdir)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
