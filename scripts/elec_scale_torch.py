#!/usr/bin/env python
"""Elec-scale runs of the PyTorch/CUDA port (genmmrec_tpu_torch).

Trains DiffRec, LD4MRec, GenRecV1 and DiffMM at the Amazon-elec tier
(192,403 users x 63,001 items, the synthetic fallback's interactions) on
one GPU through the port's entry points: ``Config(model, "elec")``,
``RecDataset``, ``build_train_data`` / ``build_eval_data``, ``get_model``,
``get_trainer`` and ``fit``, each model with its published YAML and the
tier's sizes, then one full valid and test evaluation. The counterpart of
``scripts/elec_scale.py``, which runs the JAX package.

For each model it records the data, build and fit seconds (the fit per
epoch), one SpMM pass over ``norm_adj`` at d = 64 and one loss+grad batch
in ms, ``torch.cuda.max_memory_allocated`` over the model's run, each
epoch's training loss and whether it is finite, and valid and test
Recall@20. An exception (an out-of-memory error among them) is recorded as
that model's error, never as a result.

Writes the JSON to ``comparison_logs/<dataset>_scale_torch.json`` (or
``--out``), merged into what the file holds, and a markdown table, with
the card's name and power limit, to ``docs/ELEC_SCALE_TORCH.md`` for the
elec tier (or ``--doc``), keeping the host tools' section that
``scripts/prep_scale_torch.py`` writes there.

Usage:
    python scripts/elec_scale_torch.py [--models DiffRec LD4MRec GenRecV1 DiffMM]
        [--epochs 1] [--dataset elec] [--config-json '{"remat_gcn": 0}'] [--tag _remat0]
        [--device cuda] [--data-cache DIR] [--out PATH] [--doc PATH]

``--data-cache DIR`` keeps the generated interaction table in
``DIR/<dataset>_table.npz`` and reads it back in a later run, so that the
generator's per-user loop (minutes at elec) runs once for several runs.
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# the trainers' phase lines (diffusion losses, regeneration times)
logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s", stream=sys.stdout)

MODELS = ("DiffRec", "LD4MRec", "GenRecV1", "DiffMM")


def card_line(device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or the
    CPU's mark off the card."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def load_dataset(config, cache_dir):
    """``RecDataset(config)`` (the generator's table when the tier has no
    file) and its seconds; with ``cache_dir`` the table and labels are kept
    there after the first generation and read back after it."""
    import numpy as np

    from genmmrec_tpu_torch.data.dataset import InterTable, RecDataset

    t0 = time.time()
    path = cache_dir and os.path.join(cache_dir, f"{config['dataset']}_table.npz")
    if path and os.path.isfile(path):
        z = np.load(path)
        table = InterTable(z["users"], z["items"], int(z["n_users"]), int(z["n_items"]), times=z["times"])
        ds = RecDataset(config, table)
        ds.labels = z["labels"]
        return ds, time.time() - t0, True
    ds = RecDataset(config)
    if path:
        os.makedirs(cache_dir, exist_ok=True)
        t = ds.table
        np.savez(path, users=t.users, items=t.items, labels=ds.labels, times=t.times,
                 n_users=ds.user_num, n_items=ds.item_num)
    return ds, time.time() - t0, False


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def micro_profile(model, trainer, config, device) -> dict:
    """One SpMM pass over ``norm_adj`` at d = 64 (ten, averaged) and one
    loss+grad batch (three, averaged), in ms: the JAX script's
    micro-profile, on the trained model and its state."""
    import torch

    from genmmrec_tpu_torch.ops.graph import spmm

    prof = {}
    try:
        if getattr(model, "norm_adj", None) is not None:
            x = torch.zeros(model.norm_adj.n_rows, 64, device=device)
            spmm(model.norm_adj, x)
            sync(device)
            t0 = time.time()
            for _ in range(10):
                x = spmm(model.norm_adj, x)
            sync(device)
            prof["spmm_pass_ms"] = (time.time() - t0) / 10 * 1e3
    except Exception as e:  # recorded, not raised: the fit's results stand
        prof["spmm_pass_err"] = f"{type(e).__name__}: {e}"[:300]
    try:
        B = int(config["train_batch_size"])
        batch = {
            "users": torch.zeros(B, dtype=torch.int64, device=device),
            "pos": torch.zeros(B, dtype=torch.int64, device=device),
            "neg": torch.ones(B, dtype=torch.int64, device=device),
            "weight": torch.ones(B, device=device),
        }
        gen = torch.Generator(device=device).manual_seed(2)

        def loss_grad():
            model.zero_grad(set_to_none=True)
            with torch.enable_grad():
                total, _ = model.loss_and_update(trainer.state, batch, gen)
                total.backward()
            return total

        loss_grad()
        sync(device)
        t0 = time.time()
        for _ in range(3):
            loss_grad()
        sync(device)
        prof["loss_grad_batch_ms"] = (time.time() - t0) / 3 * 1e3
        model.zero_grad(set_to_none=True)
    except Exception as e:
        prof["loss_grad_err"] = f"{type(e).__name__}: {e}"[:300]
    return prof


def run_model(name, dataset, epochs, extra, device, cache_dir) -> dict:
    import numpy as np
    import torch

    from genmmrec_tpu_torch.config import Config
    from genmmrec_tpu_torch.data.arrays import build_eval_data, build_train_data
    from genmmrec_tpu_torch.engine.evaluator import group_masks
    from genmmrec_tpu_torch.engine.trainer import get_trainer
    from genmmrec_tpu_torch.models import get_model
    from genmmrec_tpu_torch.utils.misc import init_seed

    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    config = Config(name, dataset, {
        "epochs": epochs,
        "stopping_step": epochs + 1,
        "eval_step": epochs,  # one valid + test evaluation, at the end
        "save_recommended_topk": False,
        "hyper_parameters": ["seed"],
        **extra,
    })
    seed = config["seed"]
    init_seed(int(seed[0] if isinstance(seed, list) else seed))
    ds, t_data, cached = load_dataset(config, cache_dir)
    train_ds, valid_ds, test_ds = ds.split()

    t0 = time.time()
    td = build_train_data(train_ds, device)
    ebs = int(config["eval_batch_size"])
    vd = build_eval_data(valid_ds, train_ds, ebs, device)
    ted = build_eval_data(test_ds, train_ds, ebs, device)
    config["pop_mask"], config["warm_mask"] = group_masks(train_ds, device)
    model = get_model(name)(config, td)
    trainer = get_trainer(name)(config, model)
    sync(device)
    t_build = time.time() - t0

    t0 = time.time()
    _, valid_res, test_res = trainer.fit(td, vd, ted, saved=False)
    sync(device)
    t_fit = time.time() - t0
    losses = {int(k): float(v) for k, v in trainer.train_loss_dict.items()}
    out = {
        "model": name,
        "dataset": dataset,
        "n_users": int(model.n_users),
        "n_items": int(model.n_items),
        "n_inter_train": int(td.n_inter),
        "epochs": epochs,
        "epochs_run": len(trainer.epoch_times),
        "config_extra": extra,
        "data_s": t_data,
        "data_from_cache": cached,
        "build_s": t_build,
        "fit_s": t_fit,
        "fit_s_per_epoch": t_fit / max(1, len(trainer.epoch_times)),
        "epoch_s": list(trainer.epoch_times),
        "train_loss": losses,
        "train_loss_finite": {k: math.isfinite(v) for k, v in losses.items()},
        "valid_recall@20": float(valid_res.get("recall@20", float("nan"))),
        "test_recall@20": float(test_res.get("recall@20", float("nan"))),
    }
    if hasattr(model, "remat"):
        out["remat"] = bool(model.remat)
    prelude = getattr(trainer, "prelude_log", None)
    if prelude:
        out["last_prelude"] = {k: float(v) for k, v in prelude.items()}
    out.update(micro_profile(model, trainer, config, device))
    if device.type == "cuda":
        out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated(device) / 2**30
    del trainer, model, td, vd, ted
    return out


def table(results: dict, card: str) -> str:
    cell = lambda v, f="{:.4f}": "" if v is None else f.format(v)
    lines = [
        "# Elec-scale runs of the PyTorch/CUDA port",
        "",
        "DiffRec, LD4MRec, GenRecV1 and DiffMM at the Amazon-elec tier (192,403 users x 63,001 items, "
        "the synthetic fallback's interactions, the JAX package's generator and table) through the port's "
        "entry points (`Config`, `RecDataset`, `get_model`, `get_trainer`, `fit`), each with its published "
        "YAML, then one full valid and test evaluation. Generated by `scripts/elec_scale_torch.py`; the "
        "JSON is `comparison_logs/elec_scale_torch.json`.",
        "",
        f"Card: {card}. Peak memory: `torch.cuda.max_memory_allocated` over the model's run.",
        "",
        "| Model | epochs | data s | build s | fit s/epoch | epoch losses | SpMM pass ms | loss+grad ms "
        "| peak GB | valid R@20 | test R@20 |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for key, r in results.items():
        if "error" in r:
            lines.append(f"| {key} | ERROR: `{r['error'][:160]}` | | | | | | | | | |")
            continue
        shown = ", ".join(f"{v:.4g}" for v in r["train_loss"].values())
        lines.append(
            f"| {key} | {r['epochs_run']}/{r['epochs']} | {r['data_s']:.1f}{' (cache)' if r['data_from_cache'] else ''} "
            f"| {r['build_s']:.1f} | {r['fit_s_per_epoch']:.1f} | {shown} | {cell(r.get('spmm_pass_ms'), '{:.2f}')} "
            f"| {cell(r.get('loss_grad_batch_ms'), '{:.2f}')} | {cell(r.get('max_memory_allocated_gb'), '{:.2f}')} "
            f"| {r['valid_recall@20']:.4f} | {r['test_recall@20']:.4f} |"
        )
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--models", nargs="*", default=list(MODELS))
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--dataset", default="elec", help="another tier, to try the script itself at a small size")
    ap.add_argument("--config-json", default="{}", help="config overrides, e.g. '{\"remat_gcn\": 0}'")
    ap.add_argument("--tag", default="", help="suffix of the results' keys (DiffMM_remat0 beside DiffMM)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--data-cache", default=None, help="a directory to keep the generated table in")
    ap.add_argument("--out", default=None, help="the JSON file (default comparison_logs/<dataset>_scale_torch.json)")
    ap.add_argument("--doc", default=None, help="the markdown file (default docs/ELEC_SCALE_TORCH.md at elec)")
    args = ap.parse_args(argv)

    import torch

    from genmmrec_tpu_torch.quick_start import resolve_device

    device = resolve_device(args.device)
    extra = json.loads(args.config_json)
    card = card_line(device)
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    out_path = args.out or os.path.join(ROOT, "comparison_logs", f"{args.dataset}_scale_torch.json")
    doc_path = args.doc or (os.path.join(ROOT, "docs", "ELEC_SCALE_TORCH.md") if args.dataset == "elec" else None)
    results = {}
    if os.path.exists(out_path):
        with open(out_path) as f:
            results = json.load(f)

    failed = False
    for name in args.models:
        key = name + args.tag
        print(f"=== {key} @ {args.dataset} on {device} ===", flush=True)
        try:
            r = run_model(name, args.dataset, args.epochs, extra, device, args.data_cache)
            r["card"] = card
        except Exception as e:  # an OOM or a fault is that model's result, recorded as an error
            import traceback

            traceback.print_exc()
            r = {"model": name, "card": card, "error": f"{type(e).__name__}: {e}"[:6000]}
            failed = True
        results[key] = r
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(results, f, indent=2)
            f.write("\n")
        print(json.dumps(r), flush=True)

    text = table(results, card)
    print("\n" + text)
    if doc_path:
        # the host tools' section (scripts/prep_scale_torch.py) stays
        kept = open(doc_path).read() if os.path.exists(doc_path) else ""
        cut = kept.find("## The host tools at ")
        with open(doc_path, "w") as f:
            f.write(text + ("\n" + kept[cut:] if cut >= 0 else ""))
        print("WROTE", doc_path)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
