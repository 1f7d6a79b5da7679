#!/usr/bin/env python3
"""RF-GUME prior-guidance ablation of the PyTorch/CUDA port (counterpart of
``scripts/run_ablation_prior.py``): four configurations — baseline (no
guidance), user_only, cosine_only, both — over the tuned per-dataset GUME
hyper-parameters of ``run_rfgume_torch.py``, one ``python -m
genmmrec_tpu_torch`` child each (RFGUME's YAML grid, ``rf_loss_weight``,
three values, runs in each), on the card unless ``--device cpu`` is given.
Guidance strength is ``user_guidance_scale`` / ``cosine_guidance_scale``
(0 disables the term). With ``--journal`` each child's row is recorded
under ``RFGUME/<dataset>/<ablation>``.

Usage: python scripts/run_ablation_prior_torch.py --dataset baby [--device cpu] [--epochs N] [--only both]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import harness_torch as H  # noqa: E402  (same directory)
from run_rfgume_torch import DATASET_CONFIGS, run_rfgume  # noqa: E402  (same directory)

ABLATIONS = {
    "baseline": {"user_guidance_scale": 0.0, "cosine_guidance_scale": 0.0},
    "user_only": {"user_guidance_scale": 0.2, "cosine_guidance_scale": 0.0},
    "cosine_only": {"user_guidance_scale": 0.0, "cosine_guidance_scale": 0.1},
    "both": {"user_guidance_scale": 0.2, "cosine_guidance_scale": 0.1},
}


def run_ablation(name: str, dataset: str, epochs=None, timeout=7200, device="cuda", workdir=H.WORKDIR, journal=None,
                 info=None) -> dict:
    overrides = {**DATASET_CONFIGS.get(dataset, {}), **ABLATIONS[name]}
    return run_rfgume(overrides, dataset, f"RFGUME/{dataset}/{name}", f"ablation:{name}", epochs, timeout, device,
                      workdir, journal, info, harness="run_ablation_prior_torch")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="baby")
    ap.add_argument("--only", nargs="+", choices=list(ABLATIONS), default=list(ABLATIONS),
                    help="the ablations to run (default all four)")
    H.add_common_args(ap)
    args = ap.parse_args(argv)
    info = H.run_info(args)
    rows = [run_ablation(name, args.dataset, args.epochs, args.timeout, args.device, args.workdir, args.journal, info)
            for name in args.only]
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
