#!/usr/bin/env python3
"""Batch RF-model training harness of the PyTorch/CUDA port (counterpart
of ``run_rf_models.py``): per model/dataset overrides plus ``use_rf`` in a
temporary ``--config-json`` file, one ``python -m genmmrec_tpu_torch``
child a (model, dataset, use_rf), on the card unless ``--device cpu`` is
given, in the harnesses' work directory (``harness_torch.py``). Each child
runs its YAML's grid (``rf_loss_weight``, three values, for the RF hosts).
With ``--journal`` each child's row is recorded under
``<model>/<dataset>/rf`` or ``.../norf``.

Usage:
  python scripts/run_rf_models_torch.py --dataset baby --models all
  python scripts/run_rf_models_torch.py --dataset sports --models RFLGMRec RFBM3 --use_rf true false
  python scripts/run_rf_models_torch.py --device cpu -d tiny --models RFBM3 --use_rf false --epochs 1
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import harness_torch as H  # noqa: E402  (same directory)

ALL_RF_MODELS = [
    "RFGUME", "RFBM3", "RFFREEDOM", "RFLGMRec", "RFLATTICE", "RFMGCN",
    "RFMMGCN", "RFDualGNN", "RFGRCN", "RFCOHESION", "RFSMORE", "RFPGL",
    "RFVBPR", "RFMRec", "RFBPR_remove", "RFLightGCN_remove",
    "RFLayerGCN_remove",
]

# per-model/dataset tuned overrides (reference MODEL_DATASET_CONFIGS)
MODEL_DATASET_CONFIGS = {
    "RFLGMRec": {
        "baby": {"n_hyper_layer": 1, "hyper_num": 4, "keep_rate": 0.5, "alpha": 0.3},
        "sports": {"n_hyper_layer": 1, "hyper_num": 4, "keep_rate": 0.4, "alpha": 0.6},
        "clothing": {"n_hyper_layer": 2, "hyper_num": 64, "keep_rate": 0.2, "alpha": 0.2},
    },
    "RFBM3": {
        "baby": {"n_layers": 1, "dropout": 0.3, "reg_weight": 0.1, "cl_weight": 2.0},
        "sports": {"n_layers": 1, "dropout": 0.5, "reg_weight": 0.1, "cl_weight": 2.0},
        "clothing": {"n_layers": 1, "dropout": 0.3, "reg_weight": 0.1, "cl_weight": 2.0},
    },
    "RFSMORE": {
        "baby": {"n_ui_layers": 4, "reg_weight": 1e-4, "cl_loss": 0.01,
                 "image_knn_k": 40, "text_knn_k": 15, "dropout_rate": 0.1},
        "sports": {"n_ui_layers": 3, "reg_weight": 1e-4, "cl_loss": 0.01,
                   "image_knn_k": 10, "text_knn_k": 10, "dropout_rate": 0.1},
    },
    "RFFREEDOM": {
        "baby": {"dropout": 0.9, "reg_weight": 1e-3},
        "sports": {"dropout": 0.8, "reg_weight": 1e-3},
    },
}


def run_one(model: str, dataset: str, use_rf: bool, epochs=None, timeout=7200, device: str = "cuda",
            workdir: str = H.WORKDIR, journal=None, info=None) -> dict:
    """One child; returns its journal row."""
    overrides = dict(MODEL_DATASET_CONFIGS.get(model, {}).get(dataset, {}))
    overrides["use_rf"] = use_rf
    path = H.write_overrides(overrides, "rf_overrides_")
    cmd = H.child_command(model, dataset, path, device, epochs)
    print(f"[run_rf_models_torch] {' '.join(cmd)}  overrides={overrides}", flush=True)
    try:
        rc, out, seconds = H.run_child(cmd, workdir, timeout)
    finally:
        os.unlink(path)
    row = H.row_of(cmd, rc, out, seconds, info, harness="run_rf_models_torch", dataset=dataset, overrides=overrides)
    H.record(journal, f"{model}/{dataset}/{'rf' if use_rf else 'norf'}", row)
    print(f"[run_rf_models_torch] {model} use_rf={use_rf}: {'OK' if row['ok'] else 'FAIL'} in {row['seconds']} s, "
          f"valid recall@20 {row['valid_recall@20']}, best epoch {row['best_epoch']}", flush=True)
    if not row["ok"]:
        print(row["tail"], flush=True)
    return row


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", "-d", default="baby")
    ap.add_argument("--models", nargs="+", default=["all"])
    ap.add_argument("--use_rf", nargs="+", default=["true"])
    H.add_common_args(ap)
    args = ap.parse_args(argv)

    models = ALL_RF_MODELS if args.models == ["all"] else args.models
    datasets = ["baby", "sports", "clothing"] if args.dataset == "all" else [args.dataset]
    info = H.run_info(args)
    rows = [
        run_one(model, dataset, flag.lower() == "true", args.epochs, args.timeout, args.device, args.workdir,
                args.journal, info)
        for dataset in datasets for model in models for flag in args.use_rf
    ]
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
