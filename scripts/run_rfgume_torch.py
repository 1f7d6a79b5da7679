#!/usr/bin/env python3
"""RFGUME training launcher of the PyTorch/CUDA port with per-dataset tuned
hyper-parameters (counterpart of ``scripts/run_rfgume.py``): the overrides
in a temporary ``--config-json`` file, one ``python -m genmmrec_tpu_torch``
child a dataset, on the card unless ``--device cpu`` is given, in the
harnesses' work directory (``harness_torch.py``); with ``--journal`` its
row is recorded under ``RFGUME/<dataset>``.

Usage: python scripts/run_rfgume_torch.py --dataset baby|sports|clothing|all [--device cpu] [--epochs N]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import harness_torch as H  # noqa: E402  (same directory)

DATASET_CONFIGS = {
    "baby": {"n_layers": 2, "bm_temp": 0.4, "um_loss": 0.01, "um_temp": 0.1, "vt_loss": 0.1},
    "sports": {"n_layers": 1, "bm_temp": 0.2, "um_loss": 0.01, "um_temp": 0.1, "vt_loss": 0.01},
    "clothing": {"n_layers": 1, "bm_temp": 0.2, "um_loss": 0.1, "um_temp": 0.2, "vt_loss": 0.001},
}


def run_rfgume(overrides: dict, dataset: str, key: str, tag: str, epochs=None, timeout=7200, device="cuda",
               workdir=H.WORKDIR, journal=None, info=None, harness="run_rfgume_torch") -> dict:
    """One RFGUME child with ``overrides``; returns its journal row, recorded
    under ``key``."""
    path = H.write_overrides(overrides, "rfgume_overrides_")
    cmd = H.child_command("RFGUME", dataset, path, device, epochs)
    print(f"[{tag}] {' '.join(cmd)} {overrides}", flush=True)
    try:
        rc, out, seconds = H.run_child(cmd, workdir, timeout)
    finally:
        os.unlink(path)
    row = H.row_of(cmd, rc, out, seconds, info, harness=harness, dataset=dataset, overrides=overrides)
    H.record(journal, key, row)
    print(f"[{tag}] {'OK' if row['ok'] else 'FAIL'} in {row['seconds']} s, valid recall@20 "
          f"{row['valid_recall@20']}, best epoch {row['best_epoch']} (warm-up {row['rf_warmup_epochs']})", flush=True)
    if not row["ok"]:
        print(row["tail"], flush=True)
    return row


def run(dataset: str, epochs=None, timeout=7200, device="cuda", workdir=H.WORKDIR, journal=None, info=None) -> dict:
    return run_rfgume(DATASET_CONFIGS[dataset], dataset, f"RFGUME/{dataset}", "run_rfgume_torch", epochs, timeout,
                      device, workdir, journal, info)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="baby")
    H.add_common_args(ap)
    args = ap.parse_args(argv)
    info = H.run_info(args)
    rows = [run(ds, args.epochs, args.timeout, args.device, args.workdir, args.journal, info)
            for ds in (DATASET_CONFIGS if args.dataset == "all" else [args.dataset])]
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
