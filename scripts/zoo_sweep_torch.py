#!/usr/bin/env python
"""Zoo sweep of the PyTorch/CUDA port (``genmmrec_tpu_torch``).

Trains every model of the zoo end to end through the port's command line,
``python -m genmmrec_tpu_torch -m <M> -d <DS> --epochs N``, one child
process a model, on the card unless ``--device cpu`` is given, and records
pass/fail, wall time and the final BEST block's valid Recall@20, test
Recall@20 and test NDCG@20 into a journal,
``comparison_logs/zoo_sweep_torch_<ds>[_<tag>].json``. The journal resumes:
a model with an OK row is skipped unless ``--rerun`` is given. It is the
counterpart of ``scripts/zoo_sweep.py`` (the JAX package's sweep, whose
journals are ``comparison_logs/zoo_sweep_<ds>[_<tag>].json``); the rows
are compared by ``scripts/zoo_report_torch.py``.

Each child pins the grid to one combination (``hyper_parameters: [seed]``;
every other list-valued YAML key is read at its first entry) and writes no
top-k files. It runs the CLI module as ``-m`` does (``runpy``), then prints
one line with the kernels' launch counts and the card's peak allocated
memory; the row keeps both, the set-up time up to ``fit`` and the model's
``remat`` (DiffMM's ``remat_gcn``; null for a model without it).

Usage:
    python scripts/zoo_sweep_torch.py [--dataset baby] [--epochs 2] [--timeout 900]
    python scripts/zoo_sweep_torch.py --tag converged --epochs 50 --stopping-step 5
    python scripts/zoo_sweep_torch.py --tag struct --epochs 100 --stopping-step 10 \\
        --config-json '{"data_path": "<repo>/data_struct/"}' --models BPR VBPR
    python scripts/zoo_sweep_torch.py --device cpu -d tiny --epochs 1 --models BPR

With ``--jobs`` past 1 the children share the card, but never two of
``LARGE_PLANES`` at once: a worker that is free starts the first model of
the list that may start (``next_model``). A child writes its checkpoint
under ``--workdir`` as the CLI does (several GB for the models that keep
dense item planes in their state); the sweep removes it once the row is
recorded.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ALL_MODELS = [
    # classic / graph
    "BPR", "VBPR", "LightGCN", "LayerGCN", "SELFCFED_LGN", "ItemKNNCBF",
    # multimodal graph
    "BM3", "FREEDOM", "GUME", "LATTICE", "MGCN", "LGMRec", "MMGCN", "GRCN",
    "DualGNN", "DRAGON", "COHESION", "SMORE", "PGL", "SLMRec", "MVGAE", "DAMRS",
    # diffusion
    "DiffRec", "DiffMM", "DDRM", "MCDRec", "CoDMR", "LD4MRec", "DiffGraph", "MVDiff",
    # flip diffusion
    "GenRecV1", "GenRecBM3",
    # rectified flow
    "RFMRec", "RFGUME", "RFGUMETime", "RFBM3", "RFFREEDOM", "RFLATTICE", "RFMGCN",
    "RFMMGCN", "RFVBPR", "RFLGMRec", "RFDualGNN", "RFGRCN", "RFCOHESION",
    "RFSMORE", "RFPGL", "RFBPR_remove", "RFLightGCN_remove", "RFLayerGCN_remove",
]

# the models whose item planes fill a large share of the card past sports:
# at clothing (23,033 items) they peak at 28.77, 33.03 and 30.52 GB
# (PERF.md §5), and three at once would not fit in 80 GB. At most one of
# them runs at a time.
LARGE_PLANES = ("LATTICE", "RFLATTICE", "MVDiff")

CHILD_TAG = "zoo child "
# the child: the CLI module run as ``python -m`` runs it, timed up to
# ``Trainer.fit``, then one line with the launch counters and peak memory
CHILD = f"""
import json, runpy, sys, time
t0 = time.perf_counter()
import torch
from genmmrec_tpu_torch.engine import trainer as T
from genmmrec_tpu_torch.ops import launch_counts
import_s = time.perf_counter() - t0
marks = {{}}
fit = T.Trainer.fit
def timed_fit(self, *a, **kw):
    marks.setdefault("setup_s", time.perf_counter() - t0)
    marks.setdefault("remat", getattr(self.model, "remat", None))
    t1 = time.perf_counter()
    try:
        return fit(self, *a, **kw)
    finally:
        marks["fit_s"] = marks.get("fit_s", 0.0) + time.perf_counter() - t1
T.Trainer.fit = timed_fit
sys.argv = ["genmmrec_tpu_torch"] + sys.argv[1:]
runpy.run_module("genmmrec_tpu_torch", run_name="__main__", alter_sys=True)
peak = torch.cuda.max_memory_allocated() if torch.cuda.is_initialized() else None
print({CHILD_TAG!r} + json.dumps(dict(
    import_s=import_s, total_s=time.perf_counter() - t0, peak_allocated_bytes=peak,
    launches=launch_counts(), **marks,
)), flush=True)
"""

_NUM = r"(-?(?:[0-9]+\.?[0-9]*(?:[eE][-+]?[0-9]+)?|nan|inf))"
_EPOCH = re.compile(r"epoch (\d+) training \[time: ([0-9.]+)s, ([^\]]*)\]")
_EVAL = re.compile(r"epoch (\d+) evaluating \[time: ([0-9.]+)s, valid_score: " + _NUM + r"\]")


def parse_best(out: str):
    """(valid Recall@20, test Recall@20, test NDCG@20) of the final BEST
    block of a CLI log, each None where it is absent; all None when the
    log has no BEST block. The parse is anchored to the last ``BEST`` and
    to its ``Test:`` section, as ``scripts/zoo_sweep.py`` anchors it."""
    pos = out.rfind("BEST")
    if pos < 0:
        return None, None, None
    best = out[pos:]
    tpos = best.find("Test:")
    m = re.search(r"recall@20: ([0-9.]+|nan|inf)", best[: tpos if tpos > 0 else None])
    valid = float(m.group(1)) if m else None
    test_r20 = test_n20 = None
    if tpos > 0:
        mt = re.search(r"(?<![A-Za-z_%])recall@20: ([0-9.]+|nan|inf)", best[tpos:])
        test_r20 = float(mt.group(1)) if mt else None
        mn = re.search(r"(?<![A-Za-z_%])ndcg@20: ([0-9.]+|nan|inf)", best[tpos:])
        test_n20 = float(mn.group(1)) if mn else None
    return valid, test_r20, test_n20


def parse_epochs(out: str) -> dict:
    """The training epochs of a CLI log: their count, seconds, last loss
    line, whether every loss is finite and the ``Loss is nan`` abort is
    absent, and the valid evaluations' count, seconds and scores (the
    valid Recall@20 of each, in epoch order)."""
    epochs = _EPOCH.findall(out)
    losses = [float(v) for _, _, text in epochs for v in re.findall(_NUM + r"(?=,|$)", text)]
    evals = _EVAL.findall(out)
    return {
        "epochs_run": len(epochs),
        "train_s": round(sum(float(t) for _, t, _ in epochs), 2),
        "last_loss": epochs[-1][2] if epochs else None,
        "losses_finite": "Loss is nan" not in out and all(math.isfinite(v) for v in losses),
        "evals_run": len(evals),
        "valid_eval_s": round(sum(float(t) for _, t, _ in evals), 2),
        "valid_scores": [float(v) for _, _, v in evals],
    }


def card_line(device: str) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or the
    device's name where it is not a card."""
    if device.startswith("cpu"):
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        out = []
    return out[0].strip() if out else "nvidia-smi gave nothing"


def run_one(model: str, dataset: str, epochs: int, timeout: int, stopping_step: int | None = None,
            device: str = "cuda", overrides: dict | None = None, workdir: str = ROOT, card: str = "") -> dict:
    cfg = {"hyper_parameters": ["seed"], "save_recommended_topk": False}
    if stopping_step is not None:
        cfg["stopping_step"] = stopping_step
    cfg.update(overrides or {})
    # the row keeps the overrides with the checkout's path as <repo>, so a
    # journal reads the same from any checkout
    recorded = json.loads(json.dumps(cfg).replace(ROOT, "<repo>"))
    args = ["-m", model, "-d", dataset, "--epochs", str(epochs), "--config-json", json.dumps(cfg),
            "--device", device]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [ROOT, os.environ.get("PYTHONPATH")])))
    t0 = time.time()
    try:
        res = subprocess.run([sys.executable, "-c", CHILD, *args], cwd=workdir, env=env, capture_output=True,
                             text=True, timeout=timeout)
    except subprocess.TimeoutExpired as e:
        tail = (e.stderr or b"")[-2000:]
        return {"ok": False, "seconds": timeout, "valid_recall@20": None, "test_recall@20": None,
                "test_ndcg@20": None, "epochs_budget": epochs, "returncode": None,
                "tail": "TIMEOUT " + (tail.decode(errors="replace") if isinstance(tail, bytes) else tail),
                "card": card, "config": recorded}
    dt = time.time() - t0
    out = res.stdout + res.stderr
    valid_r20, test_r20, test_n20 = parse_best(out)
    row = {"seconds": round(dt, 1), "valid_recall@20": valid_r20, "test_recall@20": test_r20,
           "test_ndcg@20": test_n20, "epochs_budget": epochs, "returncode": res.returncode}
    row.update(parse_epochs(out))
    child = [ln for ln in res.stdout.splitlines() if ln.startswith(CHILD_TAG)]
    if child:
        row["child"] = json.loads(child[-1][len(CHILD_TAG):])
    metrics = (valid_r20, test_r20, test_n20)
    row["ok"] = (
        res.returncode == 0 and "BEST" in out and row["losses_finite"]
        and all(v is not None and math.isfinite(v) for v in metrics)
    )
    row["tail"] = "" if row["ok"] else out[-2000:]
    row["card"] = card
    row["config"] = recorded
    return row


def next_model(queue: list, running: set):
    """The first model of ``queue`` that may start beside ``running``: any
    but one of ``LARGE_PLANES`` while another of them runs. None when every
    model left must wait."""
    busy = any(m in LARGE_PLANES for m in running)
    for m in queue:
        if not (busy and m in LARGE_PLANES):
            return m
    return None


def journal_path(dataset: str, tag: str | None) -> str:
    tag = f"_{tag}" if tag else ""
    return os.path.join(ROOT, "comparison_logs", f"zoo_sweep_torch_{dataset}{tag}.json")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", "-d", default="baby")
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--stopping-step", type=int, default=None,
                    help="early-stopping patience override (config default 25)")
    ap.add_argument("--timeout", type=int, default=900, help="seconds a model")
    ap.add_argument("--models", nargs="*", default=None)
    ap.add_argument("--tag", default=None,
                    help="journal tag, e.g. 'converged' -> zoo_sweep_torch_<ds>_converged.json")
    ap.add_argument("--rerun", action="store_true",
                    help="run models again even where the journal has an OK row")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--config-json", default=None,
                    help="overrides merged into the pinned ones (inline JSON dict), e.g. a data_path or a seed")
    ap.add_argument("--out", default=None, help="journal path (default comparison_logs/zoo_sweep_torch_<ds>[_<tag>].json)")
    ap.add_argument("--workdir", default=ROOT,
                    help="working directory of the children (log/ and saved/ land there; default the repository)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="children at once; past 1 they share the card and the host, and so do their wall times")
    args = ap.parse_args(argv)

    models = args.models or ALL_MODELS
    out_path = args.out or journal_path(args.dataset, args.tag)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    os.makedirs(args.workdir, exist_ok=True)
    overrides = json.loads(args.config_json) if args.config_json else {}
    results = {}
    if os.path.exists(out_path):
        with open(out_path) as f:
            results = json.load(f)
    card = card_line(args.device)
    print(f"zoo sweep: {len(models)} models on {args.device} [{card}] -> {out_path}", flush=True)

    lock = threading.Condition()
    queue, running = [], set()
    for i, model in enumerate(models):
        if model in results and results[model]["ok"] and not args.rerun:
            print(f"[{i + 1}/{len(models)}] {model}: cached OK", flush=True)
        else:
            queue.append(model)

    def worker():
        while True:
            with lock:
                model = None
                while queue and (model := next_model(queue, running)) is None:
                    lock.wait()
                if model is None:
                    return
                queue.remove(model)
                running.add(model)
            print(f"[{models.index(model) + 1}/{len(models)}] {model} ...", flush=True)
            try:
                row = run_one(model, args.dataset, args.epochs, args.timeout, args.stopping_step, args.device,
                              overrides, args.workdir, card)
            finally:
                with lock:
                    running.discard(model)
                    lock.notify_all()
            row["jobs"] = args.jobs
            ckpt = os.path.join(args.workdir, "saved", f"{model}-{args.dataset}.pt")
            if os.path.exists(ckpt):
                os.remove(ckpt)
            with lock:
                results[model] = row
                print(
                    f"    {model}: {'OK' if row['ok'] else 'FAIL'} in {row['seconds']}s, "
                    f"{row.get('epochs_run')} epochs, valid recall@20={row['valid_recall@20']}", flush=True,
                )
                with open(out_path, "w") as f:
                    json.dump(results, f, indent=2, sort_keys=True)
                    f.write("\n")

    with ThreadPoolExecutor(max_workers=max(1, args.jobs)) as pool:
        for f in [pool.submit(worker) for _ in range(max(1, args.jobs))]:
            f.result()

    n_ok = sum(1 for m in models if results.get(m, {}).get("ok"))
    print(f"\n{n_ok}/{len(models)} models OK — {out_path}")
    return 0 if n_ok == len(models) else 1


if __name__ == "__main__":
    sys.exit(main())
