#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (genmmrec_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives DiffMM's serving path on Amazon-baby at full width (19,445 users x
7,050 items, the synthetic fallback data, parameters from a seeded
generator): regenerate the two modal user-item graphs, then evaluate the
valid split and the test split with the full metric set. Before that it
builds the CUDA kernels from ``genmmrec_tpu_torch/csrc`` and holds each one
against its plain PyTorch version, on the card, at the shapes the slice
gives it, and times both with CUDA events.

It fails (non-zero exit, no result line) when no CUDA device is present, a
kernel does not build, launch or agree, a kernel of the path was not
launched during the slice, or a metric is not finite. Its last line is one
JSON object with ``"ok": true`` and the device; the line before it holds the
kernels' results as JSON.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

SEED = 2024
# K1 and its plain version differ only in the order of their float32 sums
# (the plain one adds with atomics, in an order that changes from run to
# run). Such differences scale with the sum of the terms' magnitudes, not
# with the result: a row whose terms cancel has a small result and the same
# rounding. So each element is held to K1_RTOL * Σ|vals·x| + K1_ATOL.
K1_RTOL, K1_ATOL = 1e-5, 1e-6


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call on the current stream, after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def timed_pair(torch, kernel_fn, plain_fn):
    """(kernel ms, plain ms), measured in turns: plain, kernel, kernel, plain."""
    p1 = cuda_ms(torch, plain_fn)
    k1 = cuda_ms(torch, kernel_fn)
    k2 = cuda_ms(torch, kernel_fn)
    p2 = cuda_ms(torch, plain_fn)
    return (k1 + k2) / 2, (p1 + p2) / 2


def check_k1(torch, graphs, card):
    """K1 against its plain version on each (name, graph, d) case."""
    from genmmrec_tpu_torch.ops.segment import segment_spmm, segment_spmm_plain

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases, err, ms, plain_ms = [], 0.0, 0.0, 0.0
    for name, g, d in graphs:
        x = torch.randn(g.n_cols, d, generator=gen, device="cuda")
        args = (g.row_ptr, g.cols, g.vals, x, g.n_rows)
        out = segment_spmm(*args)
        ref = segment_spmm_plain(*args)
        magnitude = segment_spmm_plain(g.row_ptr, g.cols, g.vals.abs(), x.abs(), g.n_rows)
        torch.cuda.synchronize()
        diff = (out - ref).abs()
        e = diff.max().item()
        if not bool((diff <= K1_RTOL * magnitude + K1_ATOL).all()):
            raise AssertionError(f"K1 {name}: kernel and plain version differ by up to {e:.3e}")
        if not torch.equal(segment_spmm(*args), out):
            raise AssertionError(f"K1 {name}: two launches on the same input differ")
        k_ms, p_ms = timed_pair(torch, lambda: segment_spmm(*args), lambda: segment_spmm_plain(*args))
        max_row = int((g.row_ptr[1:] - g.row_ptr[:-1]).max())
        print(
            f"K1 {name}: n_rows={g.n_rows} nnz={g.nnz} longest_row={max_row} d={d} max_abs_err={e:.3e} repeatable, "
            f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms [{card}]"
        )
        cases.append(
            dict(case=name, n_rows=g.n_rows, nnz=g.nnz, longest_row=max_row, d=d, max_abs_err=e, ms=k_ms, plain_ms=p_ms)
        )
        err, ms, plain_ms = max(err, e), ms + k_ms, plain_ms + p_ms
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, cases=cases)


def check_k3(torch, cases_in, card):
    """K3 against its plain version on each (name, scores, k, mask) case:
    indices equal, values equal where finite."""
    from genmmrec_tpu_torch.ops.topk import grouped_topk, grouped_topk_plain

    cases, err, ms, plain_ms = [], 0.0, 0.0, 0.0
    for name, s, k, m in cases_in:
        v, i = grouped_topk(s, k, packed_mask=m)
        v_ref, i_ref = grouped_topk_plain(s, k, packed_mask=m)
        torch.cuda.synchronize()
        if not torch.equal(i, i_ref):
            bad = (i != i_ref).any(dim=1).sum().item()
            raise AssertionError(f"K3 {name}: indices differ in {bad} rows")
        fin = torch.isfinite(v_ref)
        if not torch.equal(v[fin], v_ref[fin]):
            raise AssertionError(f"K3 {name}: values differ")
        e = (v[fin] - v_ref[fin]).abs().max().item() if fin.any() else 0.0
        k_ms, p_ms = timed_pair(
            torch, lambda: grouped_topk(s, k, packed_mask=m), lambda: grouped_topk_plain(s, k, packed_mask=m)
        )
        print(
            f"K3 {name}: scores {tuple(s.shape)} k={k} mask={'yes' if m is not None else 'no'} "
            f"indices equal, max_abs_err={e:.3e} kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms [{card}]"
        )
        cases.append(dict(case=name, shape=list(s.shape), k=k, max_abs_err=e, ms=k_ms, plain_ms=p_ms))
        err, ms, plain_ms = max(err, e), ms + k_ms, plain_ms + p_ms
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, cases=cases)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1

    from genmmrec_tpu_torch.config import Config
    from genmmrec_tpu_torch.data.arrays import build_eval_data, build_train_data
    from genmmrec_tpu_torch.data.dataset import RecDataset
    from genmmrec_tpu_torch.engine.diffusion_trainers import DiffMMTrainer
    from genmmrec_tpu_torch.engine.evaluator import group_masks
    from genmmrec_tpu_torch.engine.trainer import full_precision_matmuls
    from genmmrec_tpu_torch.models.diffmm import DiffMM
    from genmmrec_tpu_torch.ops import _build
    from genmmrec_tpu_torch.ops.segment import segment_spmm
    from genmmrec_tpu_torch.ops.topk import grouped_topk, grouped_topk_plain

    dev = torch.device("cuda:0")
    full_precision_matmuls()
    torch.set_grad_enabled(False)

    # -- phase 1: device and build ----------------------------------------
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    path, build_s, log = _build.build()
    print(f"built {path} in {build_s:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")

    # -- the slice's data and model (set-up) ------------------------------
    t0 = time.perf_counter()
    config = Config("DiffMM", "baby", {"save_recommended_topk": False})
    ds = RecDataset(config)
    train_ds, valid_ds, test_ds = ds.split()
    eval_bs = int(config["eval_batch_size"])
    td = build_train_data(train_ds, dev)
    vd = build_eval_data(valid_ds, train_ds, eval_bs, dev)
    ted = build_eval_data(test_ds, train_ds, eval_bs, dev)
    config["pop_mask"], config["warm_mask"] = group_masks(train_ds, dev)
    model = DiffMM(config, td)
    model.init_params(torch.Generator(device=dev).manual_seed(SEED))
    model.eval()
    trainer = DiffMMTrainer(config, model)
    torch.cuda.synchronize()
    print(
        f"set-up: DiffMM/baby users={td.n_users} items={td.n_items} train_inters={td.n_inter} "
        f"adjacency n_rows={model.norm_adj.n_rows} nnz={model.norm_adj.nnz} "
        f"valid_users={vd.n_users_eval} test_users={ted.n_users_eval} in {time.perf_counter() - t0:.1f} s (host)"
    )

    # -- phase 2: kernels against their plain versions --------------------
    # one regeneration here gives the kernels their real inputs (and warms
    # the path up); the slice below regenerates again from the same weights
    modal = trainer.regenerate()["image_ui"]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    k1 = check_k1(
        torch,
        [
            ("adjacency_d64", model.norm_adj, model.latdim),
            ("adjacency_d128", model.norm_adj, 2 * model.latdim),
            ("regenerated_modal_graph_d64", modal, model.latdim),
        ],
        card,
    )
    B_train = trainer.train_batch_size
    eval_mask = trainer._dense_mask(vd)[:eval_bs]
    trainer._dense_mask(ted)  # the packed masks are set-up, built once per eval set
    k3 = check_k3(
        torch,
        [
            ("regenerate_top1", torch.randn(B_train, td.n_items, generator=gen, device=dev), model.rebuild_k, None),
            ("eval_top50_masked", torch.randn(eval_bs, td.n_items, generator=gen, device=dev), 50, eval_mask),
        ],
        card,
    )

    # -- phase 3: the slice -----------------------------------------------
    segment_spmm.launches = 0
    grouped_topk.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.regenerate()
    torch.cuda.synchronize()
    t_regen = time.perf_counter() - t0
    t0 = time.perf_counter()
    valid_res = trainer.evaluate(vd)
    t_valid = time.perf_counter() - t0
    t0 = time.perf_counter()
    test_res = trainer.evaluate(ted, is_test=True)
    t_test = time.perf_counter() - t0
    launches = {"segment_spmm": segment_spmm.launches, "grouped_topk": grouped_topk.launches}
    print(f"regenerate: {t_regen:.3f} s; evaluate(valid): {t_valid:.3f} s; evaluate(test): {t_test:.3f} s [{card}]")
    print(f"launches during the slice: {launches}")
    print(f"valid: {json.dumps(valid_res)}")
    print(f"test: {json.dumps(test_res)}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched during the slice")
    for split, res in (("valid", valid_res), ("test", test_res)):
        bad = [k for k, v in res.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"{split}: non-finite metrics {bad}")
    for key in ("Pop_Recall@20", "Cold_NDCG@20", "Coverage@50", "Gini@50", "Tail%@50"):
        if key not in test_res:
            raise AssertionError(f"test metrics lack {key}")
    for name, g in (("image_ui", trainer.state["image_ui"]), ("text_ui", trainer.state["text_ui"])):
        want = 2 * td.n_users * model.rebuild_k + g.n_rows
        if g.nnz != want or not bool(torch.all(g.row_ptr[1:] > g.row_ptr[:-1])):
            raise AssertionError(f"{name}: nnz {g.nnz} != {want} or an empty row")

    # the top-50 holds no train positive, and chunk 0 equals the plain version
    mask = trainer._dense_mask(ted)
    top = trainer.eval_topk(ted)
    if top.shape != (ted.users.shape[0], trainer.evaluator.max_k) or top.min().item() < 0:
        raise AssertionError(f"eval top-k has shape {tuple(top.shape)} or a pad entry")
    hit_mask = (mask.gather(1, top >> 3) >> (top & 7).to(torch.uint8)) & 1
    if hit_mask[ted.valid].any():
        raise AssertionError("a masked (train-positive) item reached the top-50")
    arts = model.eval_artifacts(trainer.state)
    scores = model.scores_cached(trainer.state, ted.users[:eval_bs], arts)
    _, ref = grouped_topk_plain(scores, trainer.evaluator.max_k, packed_mask=mask[:eval_bs])
    if not torch.equal(top[:eval_bs], ref):
        raise AssertionError("eval top-50 of chunk 0 differs from the plain version")

    # the graph rebuild and the metric suite on the card agree with the same
    # code on the CPU, on the same inputs
    cpu = torch.device("cpu")
    g = trainer.state["image_ui"]
    user_edge = (g.rows < td.n_users) & (g.rows != g.cols)
    top1 = (g.cols[user_edge].long() - td.n_users).cpu()[:, None]
    g_cpu = model.rebuild_ui_graph(top1)
    if not (torch.equal(g.rows.cpu(), g_cpu.rows) and torch.equal(g.cols.cpu(), g_cpu.cols)):
        raise AssertionError("the regenerated graph's edges differ from a CPU rebuild")
    if (g.vals.cpu() - g_cpu.vals).abs().max().item() > 1e-6:
        raise AssertionError("the regenerated graph's values differ from a CPU rebuild")
    ted_cpu = build_eval_data(test_ds, train_ds, eval_bs, cpu)
    res_cpu = trainer.evaluator.evaluate(
        top.cpu(), ted_cpu, config["pop_mask"].cpu(), config["warm_mask"].cpu(), is_test=True
    )
    off = [k for k in test_res if abs(test_res[k] - res_cpu[k]) > 1e-4 + 1e-9]
    if off:
        raise AssertionError(f"test metrics differ from the CPU evaluator: {off}")
    print(
        "checks: metrics finite, no train positive in the top-50, chunk 0 equals the plain top-k, "
        "graph rebuild and test metrics equal the CPU's"
    )

    kernels = [
        dict(
            name="segment_spmm", route="cuda", source="genmmrec_tpu_torch/csrc/segment_sum.cu",
            replaces="genmmrec_tpu/ops/segment_pallas.py:395", launches=launches["segment_spmm"], **k1,
        ),
        dict(
            name="grouped_topk", route="cuda", source="genmmrec_tpu_torch/csrc/topk.cu",
            replaces="genmmrec_tpu/ops/topk.py:135", launches=launches["grouped_topk"], **k3,
        ),
    ]
    summary = dict(regenerate_s=t_regen, eval_valid_s=t_valid, eval_test_s=t_test, card=card)
    print(json.dumps({"slice": summary}))
    print(json.dumps({"kernels": kernels}))
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
