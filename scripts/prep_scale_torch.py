#!/usr/bin/env python
"""The port's preprocessing CLI at a dataset tier's synthetic sizes.

Writes raw ratings and meta from a seed at the tier's geometry
(``chip_smoke.prep_raw_files``: the tier's synthetic table topped up to a
5-core, with noise around it), then runs ``python -m
genmmrec_tpu_torch.preprocessing`` ``rating2inter`` → ``split`` →
``reindex-feat`` → ``encode-feat`` → ``uu-graph``. Each of these is a
child process of its own, with its host seconds (the call, the import
apart), its peak resident memory (``ru_maxrss``, the import's included;
the parent stays small until they have run) and the card's peak allocated
memory; for ``uu-graph`` also ``cooccurrence_topk``'s seconds on the card
(synchronized) and its K3 launches. A step that runs past
``STEP_TIMEOUT_S`` is stopped and recorded with the end of its output; the
steps after it do not run.

Then ``chip_smoke.py``'s checks of the host tools, at this size: the
5-core against the core and a plain k-core (``check_prep_kcore``), the
``.inter`` read back by both readers (``check_prep_readers``), and a
sample of the user graph's blocks (the first, a middle and the last
``USER_GRAPH_BLOCK`` users): each block's counts built again on the device
(``cooccurrence_block``), the file's rows against K3's plain version on
them (sorted counts equal, the neighbours above each row's least count
equal), and on the card K3 against its plain version on the block
(``check_k3``, ties held as sets).

Writes one JSON to ``comparison_logs/prep_scale_torch_<dataset>.json`` (or
``--out``), the card's name and power limit in it, and at elec its section
of ``docs/ELEC_SCALE_TORCH.md`` (or ``--doc``), from ``DOC_HEADING`` to the
end of the file (``scripts/elec_scale_torch.py`` keeps that part when it
writes its table).

Usage:
    python scripts/prep_scale_torch.py [-d elec] [--work DIR] [--out PATH] [--doc PATH]
    python scripts/prep_scale_torch.py -d baby --device cpu --work /tmp/prep   # a rehearsal on the CPU
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def peak_rss_bytes() -> int:
    """The process's peak resident memory (``ru_maxrss``). A child's counts
    from its fork, so it is at least its parent's size then: the parent
    imports neither numpy nor torch before its children have run."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


STEP_TAG = "prep step "
# a step that runs longer is stopped: how far it got is the finding
STEP_TIMEOUT_S = 1800
DOC_HEADING = "## The host tools at "
STEPS = ("rating2inter", "split", "reindex-feat", "encode-feat", "uu-graph")
# one CLI step in a child: the call timed apart from the import, then its
# peak memories; uu-graph's cooccurrence_topk timed on the device
STEP_CHILD = f"""
import json, sys, time
t0 = time.perf_counter()
import torch
from genmmrec_tpu_torch.ops import graph as G, topk as K
from genmmrec_tpu_torch.preprocessing.__main__ import main
import_s = time.perf_counter() - t0
marks = {{}}
cooccurrence = G.cooccurrence_topk
def sync():
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
def timed(*a, **kw):
    sync()
    t = time.perf_counter()
    try:
        return cooccurrence(*a, **kw)
    finally:
        sync()
        marks["cooccurrence_topk_s"] = time.perf_counter() - t
G.cooccurrence_topk = timed
t1 = time.perf_counter()
main(sys.argv[1:])
sync()
from prep_scale_torch import peak_rss_bytes
print({STEP_TAG!r} + json.dumps(dict(
    import_s=import_s, step_s=time.perf_counter() - t1,
    peak_rss_bytes=peak_rss_bytes(),
    peak_allocated_bytes=torch.cuda.max_memory_allocated() if torch.cuda.is_initialized() else None,
    k3_launches=int(K.grouped_topk.launches), **marks,
)), flush=True)
"""


# the raw files in a child (``chip_smoke.prep_raw_files``); the core rows
# are handed back in a pickle beside them
RAW_CHILD = f"""
import json, os, pickle, sys, time
import numpy as np
import chip_smoke as C
from prep_scale_torch import peak_rss_bytes
work, seed, ds = sys.argv[1], int(sys.argv[2]), sys.argv[3]
t1 = time.perf_counter()
ratings, meta, core, raw = C.prep_raw_files(np, work, seed, dataset=ds)
with open(os.path.join(work, "core.pkl"), "wb") as f:
    pickle.dump(core, f)
print({STEP_TAG!r} + json.dumps(dict(raw, ratings=ratings, meta=meta, step_s=time.perf_counter() - t1,
                                     peak_rss_bytes=peak_rss_bytes())), flush=True)
"""
# the kernels built once, before the steps
BUILD_CHILD = f"""
import json
from genmmrec_tpu_torch.ops import _build
print({STEP_TAG!r} + json.dumps(dict(build_s=_build.build()[1])), flush=True)
"""


def cli_steps(ds: str, d: str, ratings: str, meta: str, device: str):
    """(name, argv) of the five CLI steps, as ``prep_path`` runs them."""
    return [
        ("rating2inter", ["rating2inter", "--ratings", ratings, "--out", d, "--dataset", ds]),
        ("split", ["split", "--inter", f"{d}/{ds}-indexed.inter", "--out", f"{d}/{ds}.inter"]),
        ("reindex-feat", ["reindex-feat", "--meta", meta, "--mapping", f"{d}/i_id_mapping.csv",
                          "--out", f"{d}/meta-{ds}.csv"]),
        ("encode-feat", ["encode-feat", "--meta", f"{d}/meta-{ds}.csv", "--out", f"{d}/text_feat.npy"]),
        ("uu-graph", ["uu-graph", "--inter", f"{d}/{ds}.inter", "--out", f"{d}/user_graph_dict.npy",
                      "--device", device]),
    ]


def run_step(argv, code: str = STEP_CHILD) -> dict:
    """One step in a child process (a CLI step, or ``code``): its child
    line, or how it ended; the parent's peak resident memory at its start."""
    path = [ROOT, os.path.join(ROOT, "scripts"), os.environ.get("PYTHONPATH")]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, path)))
    t0 = time.perf_counter()
    parent = peak_rss_bytes()
    try:
        res = subprocess.run([sys.executable, "-c", code, *argv], env=env, capture_output=True, text=True,
                             timeout=STEP_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        tail = e.stderr or b""
        tail = tail.decode(errors="replace") if isinstance(tail, bytes) else tail
        return dict(ok=False, stopped_after_s=STEP_TIMEOUT_S, tail=tail[-2000:])
    row = dict(ok=res.returncode == 0, wall_s=time.perf_counter() - t0, returncode=res.returncode,
               parent_peak_rss_bytes=parent)
    line = [ln for ln in res.stdout.splitlines() if ln.startswith(STEP_TAG)]
    if line:
        row.update(json.loads(line[-1][len(STEP_TAG):]))
    if not row["ok"] or not line:
        row["ok"] = False
        row["tail"] = (res.stdout + res.stderr)[-2000:]
    return row


def check_user_graph_blocks(torch, np, d, ds, dev, card):
    """The user graph file on a sample of its blocks against K3's plain
    version on counts built again, and on the card K3 against its plain
    version on each block."""
    import chip_smoke as C
    from genmmrec_tpu_torch.ops.graph import USER_GRAPH_BLOCK
    from genmmrec_tpu_torch.ops.precision import full_precision_matmuls
    from genmmrec_tpu_torch.ops.topk import grouped_topk_plain
    from genmmrec_tpu_torch.preprocessing import pipeline

    t = pipeline.read_table(f"{d}/{ds}.inter", "\t")
    n_users, n_items = len(np.unique(t["userID"])), int(t["itemID"].max()) + 1
    train = t["x_label"] == 0
    users, items = t["userID"][train], t["itemID"][train]
    t0 = time.perf_counter()
    graph = np.load(f"{d}/user_graph_dict.npy", allow_pickle=True).item()
    load_s = time.perf_counter() - t0
    k = min(C.PREP_TOP_K, n_users - 1)
    n_blocks = -(-n_users // USER_GRAPH_BLOCK)
    starts = sorted({0, n_blocks // 2 * USER_GRAPH_BLOCK, (n_blocks - 1) * USER_GRAPH_BLOCK})
    out = dict(users=n_users, items=n_items, blocks=n_blocks, sampled_blocks=starts, load_s=load_s, k3_cases=[])
    full = exact = 0
    full_precision_matmuls()
    for lo in starts:
        co = C.cooccurrence_block(torch, users, items, n_users, n_items, lo, dev, repeats=True)
        v, idx = grouped_topk_plain(co, k)
        v, idx = v.cpu().numpy(), idx.cpu().numpy()
        for r in range(co.shape[0]):
            m = int((v[r] > 0).sum())
            nb, w = graph[lo + r]
            want_nb, want_w = idx[r, :m].tolist(), v[r, :m].astype(np.float64).tolist()
            if sorted(w, reverse=True) != want_w:
                raise AssertionError(f"uu-graph: user {lo + r}'s counts differ from K3's plain version")
            cut = want_w[-1] if m else 0.0
            strict = lambda n_, w_: frozenset(a for a, b in zip(n_, w_) if b > cut)
            if strict(nb, w) != strict(want_nb, want_w):
                raise AssertionError(f"uu-graph: user {lo + r}'s neighbours above its least count differ")
            full += m == k
            exact += nb == want_nb
        if dev.type == "cuda":
            out["k3_cases"] += C.check_k3(torch, [(f"{ds}_uu_graph_block{lo}_top{k}", co, k, None)], card,
                                          ties_as_sets=True)["cases"]
        del co
    rows = sum(min(USER_GRAPH_BLOCK, n_users - lo) for lo in starts)
    out.update(rows_checked=rows, full_rows=full, rows_in_the_plain_order=exact)
    return out


def section(r: dict) -> str:
    """The run's section of the tier's scale document, from ``DOC_HEADING``."""
    from genmmrec_tpu_torch.ops.graph import USER_GRAPH_BLOCK

    gb = lambda b: "—" if b is None else f"{b / 1e9:.2f}"
    raw, ds = r["raw"], r["dataset"]
    lines = [
        f"{DOC_HEADING}{ds}",
        "",
        f"The port's preprocessing CLI at the {ds} tier's synthetic sizes (`scripts/prep_scale_torch.py`; the JSON is "
        f"`comparison_logs/prep_scale_torch_{ds}.json`), on {r['card']}, torch {r.get('torch', '—')}. Raw ratings and meta "
        f"written from a seed (`chip_smoke.prep_raw_files`): the tier's synthetic table ({raw['core_users']:,} users × "
        f"{raw['core_items']:,} items) topped up to a 5-core of {raw['core_rows']:,} rows, and {raw['noise_rows']:,} "
        f"rows of noise around it ({raw['raw_rows']:,} in all); the generator {raw['generate_s']:.1f} s, the files "
        f"{raw['write_s'] - raw['generate_s']:.1f} s more, the writing process's peak resident memory "
        f"{gb(raw['peak_rss_bytes'])} GB. Each step a child process of its own (of a parent at "
        f"{gb(raw['parent_peak_rss_bytes'])} GB, which a child's peak counts from): host seconds of the "
        "step's call (the import apart), its peak resident memory (`ru_maxrss`, torch's import included) and the "
        "card's peak allocated memory.",
        "",
        "| step | host s | import s | peak RSS GB | card peak GB | K3 launches |",
        "|---|---|---|---|---|---|",
    ]
    for name in STEPS:
        if name not in r["steps"]:
            continue
        st = r["steps"][name]
        if not st["ok"]:
            how = f"stopped after {st['stopped_after_s']} s" if "stopped_after_s" in st else f"rc {st.get('returncode')}"
            lines.append(f"| {name} | {how} | | | | |")
            continue
        lines.append(f"| {name} | {st['step_s']:.1f} | {st['import_s']:.1f} | {gb(st['peak_rss_bytes'])} | "
                     f"{gb(st['peak_allocated_bytes'])} | {st['k3_launches']} |")
    uu = r["steps"].get("uu-graph", {})
    g = r.get("user_graph")
    if uu.get("ok") and g:
        plane = (g["items"] + 2 * g["users"]) * USER_GRAPH_BLOCK * 4
        lines += [
            "",
            f"**The user graph on the card**: `cooccurrence_topk` {uu['cooccurrence_topk_s']:.1f} s (synchronized) "
            f"over {g['users']:,} users in {g['blocks']} blocks of {USER_GRAPH_BLOCK} (planes of (n_items + 2 "
            f"n_users) × {USER_GRAPH_BLOCK} float32s, {plane / 1e9:.2f} GB), {uu['k3_launches']} K3 launches at k = "
            f"{min(200, g['users'] - 1)}; the rest of the step is the `.inter` read and the dict's pickle.",
        ]
    if r.get("kcore"):
        k = r["kcore"]
        lines += ["", f"**The 5-core**: {k['users']:,} users, {k['items']:,} items, {k['rows']:,} rows, the core's "
                      f"rows exactly, and equal to a plain k-core in dicts ({k['plain_kcore_s']:.1f} s)."]
    if r.get("readers"):
        rd = r["readers"]
        lines += ["", f"**The `.inter` read back**: {rd['rows']:,} rows, the native parser {rd['native_s']:.2f} s, "
                      f"`csv` {rd['csv_s']:.2f} s (host), the tables equal."]
    if g:
        lines += [
            "",
            f"**A sample of the user graph's blocks** (users from {', '.join(f'{lo:,}' for lo in g['sampled_blocks'])}, "
            f"{g['rows_checked']:,} rows, {g['full_rows']:,} of them full): the file's rows against K3's plain version "
            "on the counts built again on the card, sorted counts and the neighbours above each row's least count "
            f"equal ({g['rows_in_the_plain_order']:,} rows in the plain version's order). K3 against its plain "
            "version on each block (ties held as sets), ms of kernel / plain / `torch.topk` / bound:",
            "",
        ]
        for c in g["k3_cases"]:
            lines.append(f"- `{c['case']}` {tuple(c['shape'])} k = {c['k']}: {c['ms']:.4f} / {c['plain_ms']:.4f} / "
                         f"{c['library_ms']:.4f} / {c['bound_ms']:.4f} ({c['bound_by']}); "
                         f"{c['tied_rows']} rows tied past the k-th count, {c['rows_ordered_otherwise']} in "
                         "another order than plain")
    lines += ["", f"The whole run {r['total_s']:.1f} s."]
    return "\n".join(lines) + "\n"


def write_section(doc: str, text: str) -> None:
    """Replace the document's part from ``DOC_HEADING`` on with ``text``."""
    old = open(doc).read() if os.path.exists(doc) else ""
    cut = old.find(DOC_HEADING)
    head = old if cut < 0 else old[:cut]
    with open(doc, "w") as f:
        f.write(head.rstrip("\n") + "\n\n" + text if head.strip() else text)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", "-d", default="elec")
    ap.add_argument("--work", default=None, help="directory of the files (default build/prep_<dataset>)")
    ap.add_argument("--out", default=None, help="the JSON (default comparison_logs/prep_scale_torch_<dataset>.json)")
    ap.add_argument("--doc", default=None, help="the scale document (default docs/ELEC_SCALE_TORCH.md at elec)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import chip_smoke as C

    ds = args.dataset
    work = os.path.abspath(args.work or os.path.join(ROOT, "build", f"prep_{ds}"))
    out_path = args.out or os.path.join(ROOT, "comparison_logs", f"prep_scale_torch_{ds}.json")
    doc = args.doc or (os.path.join(ROOT, "docs", "ELEC_SCALE_TORCH.md") if ds == "elec" else None)
    os.makedirs(work, exist_ok=True)
    card = C.card_line() if args.device.startswith("cuda") else "cpu"
    result = dict(dataset=ds, card=card, device=args.device, step_timeout_s=STEP_TIMEOUT_S, steps={})
    t0 = time.perf_counter()

    def save():
        result["total_s"] = time.perf_counter() - t0
        # the checkout's path as <repo>, so the file reads the same from any checkout
        with open(out_path, "w") as f:
            f.write(json.dumps(result, indent=2, sort_keys=True).replace(ROOT, "<repo>") + "\n")

    # every child before the parent imports numpy or torch: a child's peak
    # memory starts from the parent's small size
    d = os.path.join(work, ds)
    steps = [("raw", [work, str(C.SEED + 18), ds], RAW_CHILD)]
    if card != "cpu":
        steps.append(("build", [], BUILD_CHILD))
    for name, argv, code in steps:
        row = run_step(argv, code)
        if not row["ok"]:
            raise RuntimeError(f"{name} failed:\n{row.get('tail', '')}")
        result[name] = row
        print(f"{name}: {json.dumps(row)}", flush=True)
    raw = result["raw"]
    for name, step in cli_steps(ds, d, raw["ratings"], raw["meta"], args.device):
        row = run_step(step)
        result["steps"][name] = row
        print(f"{name}: {json.dumps({k: v for k, v in row.items() if k != 'tail'})} [{card}]", flush=True)
        save()
        if not row["ok"]:
            print(row.get("tail", ""))
            if doc:
                write_section(doc, section(result))
            return 1

    import pickle

    import numpy as np
    import torch

    result["torch"] = torch.__version__
    with open(os.path.join(work, "core.pkl"), "rb") as f:
        core = pickle.load(f)
    ratings = raw["ratings"]
    dev = torch.device(args.device)
    result["kcore"] = C.check_prep_kcore(d, ds, ratings, core, raw)
    print(f"5-core: {json.dumps(result['kcore'])}", flush=True)
    result["readers"] = C.check_prep_readers(np, f"{d}/{ds}.inter")[1]
    print(f".inter readers: {json.dumps(result['readers'])}", flush=True)
    result["user_graph"] = check_user_graph_blocks(torch, np, d, ds, dev, card)
    print(f"user graph: {json.dumps({k: v for k, v in result['user_graph'].items() if k != 'k3_cases'})} [{card}]")
    save()
    if doc:
        write_section(doc, section(result))
    print(f"prep_scale_torch at {ds}: every step and check done in {result['total_s']:.1f} s -> {out_path} [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
