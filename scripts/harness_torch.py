#!/usr/bin/env python
"""What the port's experiment harnesses share (``scripts/*_torch.py``, the
counterparts of ``compare_models.py``, ``run_rf_models.py`` and
``scripts/run_{rfgume,ablation_prior,rf_staged_search}.py``).

Each harness trains through the port's command line, one child process a
run::

    python -m genmmrec_tpu_torch -m <model> -d <dataset> [--config-json <file>] --device <device> [--epochs N]

on the card unless ``--device cpu`` is given. The children run in a work
directory of their own (``--workdir``, default ``harness_torch_runs/`` of
the checkout), where they write ``log/``, ``saved/`` and
``recommend_topk/``; the JAX package's harnesses run theirs in the checkout
itself, and the two never meet.

``run_child`` returns the child's output; ``parse_run`` reads it into a
journal row: the final BEST block's valid and test Recall@20 and NDCG@20,
each combination of the grid with its per-epoch valid scores, its best
epoch and whether that epoch is past ``rf_warmup_epochs`` (before it an RF
model's generated embeddings reach no score), and the CLI's last line (the
kernels' launches and the card's peak allocated memory). ``record`` adds a
row to a journal (``--journal``), a JSON file of rows by key.
"""

from __future__ import annotations

import fcntl
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKDIR = os.path.join(ROOT, "harness_torch_runs")
# the first words of the CLI's last line (genmmrec_tpu_torch/__main__.py)
RUN_TAG = "genmmrec_tpu_torch run "

_COMBO = re.compile(r"=========(\d+)/(\d+): Parameters:(.*?)=======")
_EVAL = re.compile(r"epoch (\d+) evaluating \[time: ([0-9.]+)s, valid_score: ([-0-9.eE]+|nan|inf)\]")
_EPOCH = re.compile(r"epoch (\d+) training \[time: ([0-9.]+)s, ([^\]]*)\]")
_WARMUP = re.compile(r"^rf_warmup_epochs=(\d+)", re.M)
_BEST_PARAMS = re.compile(r"BEST █+.*?Parameters: (.*?),?\n", re.S)


def add_common_args(ap) -> None:
    """The options every harness takes beside its own."""
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu, passed to every child")
    ap.add_argument("--workdir", default=WORKDIR, help="the children's working directory (log/, saved/ land there)")
    ap.add_argument("--journal", default=None, help="a JSON journal to add each child's row to")
    ap.add_argument("--timeout", type=int, default=7200, help="seconds a child")
    ap.add_argument("--concurrent", type=int, default=1,
                    help="how many harnesses share the card and the host with this one (kept in each row)")
    ap.add_argument("--epochs", type=int, default=None)


def child_command(model: str, dataset: str, config_path: str | None, device: str, epochs=None) -> list:
    cmd = [sys.executable, "-m", "genmmrec_tpu_torch", "-m", model, "-d", dataset]
    if config_path is not None:
        cmd += ["--config-json", config_path]
    cmd += ["--device", device]
    if epochs:
        cmd += ["--epochs", str(epochs)]
    return cmd


def run_child(cmd: list, workdir: str, timeout=None):
    """(return code, stdout + stderr, seconds) of one child in ``workdir``,
    the checkout on its ``PYTHONPATH``; the return code is None when the
    child outran ``timeout``."""
    os.makedirs(workdir, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [ROOT, os.environ.get("PYTHONPATH")])))
    t0 = time.time()
    try:
        res = subprocess.run(cmd, cwd=workdir, env=env, capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired as e:
        out = (e.stdout or b"") + (e.stderr or b"")
        return None, out.decode(errors="replace") if isinstance(out, bytes) else out, time.time() - t0
    return res.returncode, res.stdout + res.stderr, time.time() - t0


def _parse_metric_block(text: str):
    return {
        m.group(1): float(m.group(2))
        for m in re.finditer(r"([A-Za-z_%]+@\d+):\s*([\d.]+)", text)
    }


def parse_results(output: str):
    """Parse the final BEST block into {'valid': {...}, 'test': {...}}
    (``compare_models.py``'s parser, with its regexes)."""
    best = None
    for pattern in (
        r"█████████████ BEST ████████████████(.*?)(?=\Z)",
        r"████Current BEST████:(.*?)(?=\n\n\n|\Z)",
    ):
        m = re.search(pattern, output, re.DOTALL)
        if m:
            best = m.group(1)
            break
    if best is None:
        return None
    valid_m = re.search(r"Valid:\s*(.*?)(?:,\nTest:|$)", best, re.DOTALL)
    test_m = re.search(r"Test:\s*(.*?)$", best, re.DOTALL)
    return {
        "valid": _parse_metric_block(valid_m.group(1)) if valid_m else {},
        "test": _parse_metric_block(test_m.group(1)) if test_m else {},
    }


def parse_run(out: str) -> dict:
    """A journal row's values from a child's output (see the module's
    docstring); a value the output lacks is None."""
    row = {}
    pos = out.rfind("BEST")
    # from the last combination's block on: the final BEST block, or the
    # last ``Current BEST`` of a child that was cut before it
    best = parse_results(out[max(out.rfind("████Current BEST████"), 0):]) or {}
    for split in ("valid", "test"):
        for name in ("recall@20", "ndcg@20"):
            row[f"{split}_{name}"] = best.get(split, {}).get(name)
    m = _WARMUP.search(out)
    warmup = int(m.group(1)) if m else None
    row["rf_warmup_epochs"] = warmup
    heads = list(_COMBO.finditer(out))
    combos = []
    for i, h in enumerate(heads):
        section = out[h.end(): heads[i + 1].start() if i + 1 < len(heads) else len(out)]
        evals = [(int(e), float(v)) for e, _, v in _EVAL.findall(section)]
        scores = [v for _, v in evals]
        finite = [v for v in scores if math.isfinite(v)]
        top = max(finite) if finite else None
        best_epoch = next((e for e, v in evals if v == top), None)
        combos.append(dict(
            parameters=h.group(3).strip(), epochs_run=len(_EPOCH.findall(section)), valid_scores=scores,
            best_epoch=best_epoch, best_valid_score=top,
            past_warmup=None if warmup is None or best_epoch is None else best_epoch >= warmup,
        ))
    row["combinations"] = combos
    m = _BEST_PARAMS.search(out[pos:]) if pos >= 0 else None
    chosen = next((c for c in combos if m and c["parameters"] == m.group(1).strip()), None)
    row["best_parameters"] = chosen["parameters"] if chosen else None
    row["best_epoch"] = chosen["best_epoch"] if chosen else None
    row["past_warmup"] = chosen["past_warmup"] if chosen else None
    epochs = _EPOCH.findall(out)
    losses = [float(v) for _, _, text in epochs for v in re.findall(r"(-?[0-9.]+(?:[eE][-+]?[0-9]+)?|nan|inf)(?=,|$)",
                                                                    text)]
    row["epochs_run"] = len(epochs)
    row["train_s"] = round(sum(float(t) for _, t, _ in epochs), 2)
    row["losses_finite"] = "Loss is nan" not in out and all(math.isfinite(v) for v in losses)
    tagged = [ln for ln in out.splitlines() if ln.startswith(RUN_TAG)]
    cli = json.loads(tagged[-1][len(RUN_TAG):]) if tagged else {}
    row["launches"] = cli.get("launches")
    row["peak_allocated_bytes"] = cli.get("peak_allocated_bytes")
    row["device_name"] = cli.get("device")
    return row


def run_info(args) -> dict:
    """What every row of a harness run keeps: the card's line and how many
    harnesses ran at once."""
    return {"card": card_line(args.device), "concurrent": args.concurrent}


def row_of(cmd: list, rc, out: str, seconds: float, info: dict | None, **extra) -> dict:
    """The journal row of one child: ``parse_run``'s values, OK (exit code
    0, a BEST block with finite Recall@20 and NDCG@20, finite losses), the
    wall seconds, ``info`` (``run_info``), the command with the checkout as
    ``<repo>``."""
    row = parse_run(out)
    metrics = [row[f"{s}_{n}"] for s in ("valid", "test") for n in ("recall@20", "ndcg@20")]
    row["ok"] = rc == 0 and row["losses_finite"] and all(v is not None and math.isfinite(v) for v in metrics)
    row.update(info or {})
    row.update(returncode=rc, seconds=round(seconds, 1),
               command=[c.replace(sys.executable, "python").replace(ROOT, "<repo>") for c in cmd], **extra)
    row["tail"] = "" if row["ok"] else out[-3000:]
    return row


def record(journal: str | None, key: str, row: dict) -> None:
    """Add ``row`` under ``key`` to the JSON journal ``journal`` (none:
    nothing), under a lock beside it."""
    if not journal:
        return
    os.makedirs(os.path.dirname(os.path.abspath(journal)), exist_ok=True)
    # harnesses that run at once share a journal: one writer at a time
    with open(journal + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        rows = {}
        if os.path.exists(journal):
            with open(journal) as f:
                rows = json.load(f)
        rows[key] = row
        with open(journal, "w") as f:
            json.dump(rows, f, indent=2, sort_keys=True)
            f.write("\n")


def card_line(device: str) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    ``cpu``."""
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


def write_overrides(overrides: dict, prefix: str) -> str:
    """A temporary JSON file of ``overrides``; the caller removes it."""
    with tempfile.NamedTemporaryFile("w", suffix=".json", delete=False, prefix=prefix) as f:
        json.dump(overrides, f)
        return f.name
