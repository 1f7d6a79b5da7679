#!/usr/bin/env python
"""Model comparison harness of the PyTorch/CUDA port (counterpart of
``compare_models.py``): train each model through ``python -m
genmmrec_tpu_torch`` in a child process (2 h limit) on the card unless
``--device cpu`` is given, keep each child's output under
``<workdir>/comparison_logs/``, parse the final BEST (or the last
``████Current BEST████``) block for the valid and test metrics, and print a
side-by-side table of the test metrics. The results go to
``<workdir>/comparison_results_torch.json``; the JAX package's
``comparison_results.json`` at the checkout's root is not touched.

Usage:
    python scripts/compare_models_torch.py --models DiffMM RFMRec --dataset baby [--device cpu] [--epochs N]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from datetime import datetime

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import harness_torch as H  # noqa: E402  (same directory)


def run_model(model_name: str, dataset: str = "baby", timeout: int = 7200, extra=None, device: str = "cuda",
              workdir: str = H.WORKDIR, journal=None, info=None):
    """(the parsed BEST block, the log file) of one child; (None, None) when
    it outran ``timeout``. With ``journal`` its row is recorded under
    ``<model>``."""
    print(f"\n{'=' * 60}\nTraining {model_name} on {dataset} ...\n{'=' * 60}\n", flush=True)
    cmd = H.child_command(model_name, dataset, None, device) + (extra or [])
    rc, output, seconds = H.run_child(cmd, workdir, timeout)
    H.record(journal, model_name, H.row_of(cmd, rc, output, seconds, info, harness="compare_models_torch",
                                            dataset=dataset, overrides={}))
    if rc is None:
        print(f"{model_name} timed out ({timeout}s)")
        return None, None
    logs = os.path.join(workdir, "comparison_logs")
    os.makedirs(logs, exist_ok=True)
    stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    log_file = os.path.join(logs, f"{model_name}_{dataset}_{stamp}.log")
    with open(log_file, "w", encoding="utf-8") as f:
        f.write(output)
    print(f"{model_name} done (rc {rc}); log: {log_file}", flush=True)
    return H.parse_results(output), log_file


# the one BEST-block parser of the port's harnesses
parse_results = H.parse_results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", nargs="+", default=["DiffMM", "RFMRec"])
    ap.add_argument("--dataset", default="baby")
    H.add_common_args(ap)
    args = ap.parse_args(argv)

    extra = ["--epochs", str(args.epochs)] if args.epochs else None
    info = H.run_info(args)
    results = {}
    for model in args.models:
        metrics, _ = run_model(model, args.dataset, args.timeout, extra, args.device, args.workdir, args.journal,
                               info)
        if metrics:
            results[model] = metrics

    if not results:
        print("No results parsed.")
        return 1

    keys = sorted({k for r in results.values() for k in r["test"]})
    header = ["metric"] + list(results)
    print("\n" + "  ".join(f"{h:>16}" for h in header))
    for k in keys:
        row = [k] + [f"{results[m]['test'].get(k, float('nan')):.4f}" for m in results]
        print("  ".join(f"{c:>16}" for c in row))

    out = os.path.join(args.workdir, "comparison_results_torch.json")
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"\nSaved {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
