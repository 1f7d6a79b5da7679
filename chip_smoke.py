#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (genmmrec_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]

Drives DiffMM on Amazon-baby at full width (19,445 users x 7,050 items, the
synthetic fallback data, parameters from a seeded generator) through two
paths of the port:

- serving: regenerate the two modal user-item graphs, then evaluate the
  valid split and the test split with the full metric set;
- training: two epochs (the first a warm-up), each the denoisers' phase 1,
  the regeneration and the BPR + InfoNCE epoch, then evaluate(valid); one
  batch's loss and ``rec`` gradients are then held against the same batch on
  the CPU.

Before that it builds the CUDA kernels from ``genmmrec_tpu_torch/csrc`` and
holds each one (K1 forward, K1 backward, K3) against its plain PyTorch
version, on the card, at the shapes the paths give it, and times both with
CUDA events. ``--profile DIR`` adds one more epoch under ``torch.profiler``,
phase by phase, and writes the kernel tables to DIR.

It fails (non-zero exit, no result line) when no CUDA device is present, a
kernel does not build, launch or agree, a kernel of a path was not launched
during that path, a loss or a metric is not finite, or a phase changed
parameters it does not train. Its last line is one JSON object with
``"ok": true`` and the device; the line before it holds the kernels'
results as JSON.
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
# One training batch on the card against the same batch on the CPU: the
# two differ by float32 summation order (K1 rows, the InfoNCE denominators
# over every user, the cuBLAS and CPU GEMMs). The loss is held to a
# relative 1e-5; each gradient element to GRAD_RTOL of its own magnitude
# plus GRAD_ATOL of its tensor's largest magnitude.
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-4


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


def check_k1_backward(torch, graphs, card):
    """K1's backward (the x-gradient of ``spmm_symmetric``: K1 on the output
    cotangent, as Aᵀ = A) against the gradient through the plain version's
    autograd, on each (name, graph, d) case. Each element is held to
    K1_RTOL · Σ|vals|·|ḡ[cols]| + K1_ATOL."""
    from genmmrec_tpu_torch.ops.segment import segment_spmm_plain, spmm_symmetric

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    cases, err, ms, plain_ms = [], 0.0, 0.0, 0.0
    with torch.enable_grad():
        for name, g, d in graphs:
            x = torch.randn(g.n_cols, d, generator=gen, device="cuda").requires_grad_()
            g_bar = torch.randn(g.n_rows, d, generator=gen, device="cuda")
            kernel = lambda: spmm_symmetric(g.row_ptr, g.rows, g.cols, g.vals, x, g.n_rows)
            plain = lambda: segment_spmm_plain(g.row_ptr, g.cols, g.vals, x, g.n_rows)
            grad = lambda fwd: torch.autograd.grad(fwd(), x, g_bar)[0]
            out, ref = grad(kernel), grad(plain)
            magnitude = segment_spmm_plain(g.row_ptr, g.cols, g.vals.abs(), g_bar.abs(), g.n_rows)
            torch.cuda.synchronize()
            diff = (out - ref).abs()
            e = diff.max().item()
            if not bool((diff <= K1_RTOL * magnitude + K1_ATOL).all()):
                raise AssertionError(f"K1 backward {name}: kernel and plain gradients differ by up to {e:.3e}")
            if not torch.equal(grad(kernel), out):
                raise AssertionError(f"K1 backward {name}: two backward launches on the same input differ")
            k_ms, p_ms = timed_pair(torch, lambda: grad(kernel), lambda: grad(plain))
            # the backward alone, on a kept graph
            y_k, y_p = kernel(), plain()
            kb_ms, pb_ms = timed_pair(
                torch,
                lambda: torch.autograd.grad(y_k, x, g_bar, retain_graph=True),
                lambda: torch.autograd.grad(y_p, x, g_bar, retain_graph=True),
            )
            max_row = int((g.row_ptr[1:] - g.row_ptr[:-1]).max())
            print(
                f"K1 backward {name}: n_rows={g.n_rows} nnz={g.nnz} longest_row={max_row} d={d} "
                f"max_abs_err={e:.3e} repeatable, forward+backward kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms; "
                f"backward alone kernel {kb_ms:.4f} ms, plain {pb_ms:.4f} ms [{card}]"
            )
            cases.append(dict(
                case=name, n_rows=g.n_rows, nnz=g.nnz, longest_row=max_row, d=d, max_abs_err=e,
                ms=k_ms, plain_ms=p_ms, backward_ms=kb_ms, backward_plain_ms=pb_ms,
            ))
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


def launch_counts():
    from genmmrec_tpu_torch.ops.segment import segment_spmm, segment_spmm_backward
    from genmmrec_tpu_torch.ops.topk import grouped_topk

    return {
        "segment_spmm": segment_spmm.launches,
        "segment_spmm_backward": segment_spmm_backward.launches,
        "grouped_topk": grouped_topk.launches,
    }


def reset_counts():
    from genmmrec_tpu_torch.ops.segment import segment_spmm, segment_spmm_backward
    from genmmrec_tpu_torch.ops.topk import grouped_topk

    segment_spmm.launches = segment_spmm_backward.launches = grouped_topk.launches = 0


def train_epoch(torch, trainer, epoch: int, card, profile_dir=None):
    """One epoch as ``Trainer.fit`` runs it (the prelude's phases 1 and 2,
    then the BPR + InfoNCE epoch), timed phase by phase; each phase checked
    for the parameters it must leave alone and for its launches."""
    model = trainer.model
    groups = model.param_groups()
    snap = lambda names: [p.detach().clone() for n in names for p in groups[n]]
    same = lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b))
    dn = ("denoise_image", "denoise_text")
    res = {}

    profiler = None
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        profiler = lambda: profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def run(label, fn):
        reset_counts()
        torch.cuda.synchronize()
        if profiler is None:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            res[f"{label}_s"] = time.perf_counter() - t0
        else:
            with profiler() as prof:
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                res[f"{label}_s"] = time.perf_counter() - t0
            write_profile(torch, prof, profile_dir, f"epoch{epoch}_{label}", res[f"{label}_s"], card)
        res[f"{label}_launches"] = launch_counts()
        return out

    rec0 = snap(["rec"])
    gen = trainer.split("epoch", epoch, "prelude")
    if profiler is None:
        # the prelude's own timers split phase 1 from phase 2
        run("prelude", lambda: trainer._epoch_prelude(gen, epoch))
        log = trainer.prelude_log
    else:
        # the prelude's two phases, each under its own profiler
        steps = -(-model.n_users // trainer.train_batch_size)
        losses = run("diffusion", lambda: trainer._diffusion_epoch(gen).sum(dim=0).cpu() / steps)
        run("regenerate", lambda: trainer.regenerate(gen))
        log = dict(diffusion_s=res["diffusion_s"], regenerate_s=res["regenerate_s"],
                   diffusion_loss_image=float(losses[0]), diffusion_loss_text=float(losses[1]))
        res["prelude_launches"] = {
            k: res["diffusion_launches"][k] + res["regenerate_launches"][k] for k in res["diffusion_launches"]
        }
        res["prelude_s"] = log["diffusion_s"] + log["regenerate_s"]
    for k in ("diffusion_s", "regenerate_s", "diffusion_loss_image", "diffusion_loss_text"):
        res[k] = log[k]
    if not same(rec0, snap(["rec"])):
        raise AssertionError(f"epoch {epoch}: phases 1 and 2 changed rec parameters")
    dn0 = snap(dn)
    losses = run("bpr", lambda: trainer._train_epoch(trainer.split("epoch", epoch, "train")).cpu())
    if not same(dn0, snap(dn)):
        raise AssertionError(f"epoch {epoch}: the BPR epoch changed the denoisers")
    res["bpr_loss_sum"] = float(losses.sum())
    res["bpr_loss_first"], res["bpr_loss_last"] = float(losses[0, 0]), float(losses[-1, 0])
    res["bpr_batches"] = losses.shape[0]
    finite = [res[k] for k in ("diffusion_loss_image", "diffusion_loss_text", "bpr_loss_sum")]
    if not all(math.isfinite(v) for v in finite) or not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"epoch {epoch}: a loss is not finite: {finite}")
    bpr = res["bpr_launches"]
    if bpr["segment_spmm"] <= 0 or bpr["segment_spmm_backward"] <= 0:
        raise AssertionError(f"epoch {epoch}: K1 forward or backward not launched in the BPR epoch: {bpr}")
    if res["prelude_launches"]["grouped_topk"] <= 0:
        raise AssertionError(f"epoch {epoch}: K3 not launched in the regeneration")
    res["epoch_s"] = res["prelude_s"] + res["bpr_s"]
    res["phase1_users_per_s"] = model.n_users / res["diffusion_s"]
    print(
        f"epoch {epoch}: phase 1 (denoisers) {res['diffusion_s']:.3f} s "
        f"({res['phase1_users_per_s']:.0f} users/s), loss image {res['diffusion_loss_image']:.4f} "
        f"text {res['diffusion_loss_text']:.4f}; phase 2 (regenerate) {res['regenerate_s']:.3f} s; "
        f"phase 3 (BPR+InfoNCE, {res['bpr_batches']} batches) {res['bpr_s']:.3f} s, loss first "
        f"{res['bpr_loss_first']:.4f} last {res['bpr_loss_last']:.4f} sum {res['bpr_loss_sum']:.4f}; "
        f"epoch {res['epoch_s']:.3f} s [{card}]"
    )
    print(f"epoch {epoch}: launches, prelude {res['prelude_launches']}, BPR epoch {bpr}")
    return res


def write_profile(torch, prof, out_dir, label, wall_s, card):
    """The phase's kernel table to ``out_dir/label.txt`` and its device time
    and busy share to stdout."""
    import os

    os.makedirs(out_dir, exist_ok=True)
    events = prof.key_averages()
    key = "self_device_time_total" if hasattr(events[0], "self_device_time_total") else "self_cuda_time_total"
    dev_us = lambda e: getattr(e, key)
    # the kernels themselves: the operator rows repeat their time, and a
    # user annotation (the optimizer's step) spans kernels on the device too
    spans = {e.name for e in prof.events() if getattr(e, "is_user_annotation", False)}
    kernels = sorted(
        (e for e in events if str(e.device_type).endswith("CUDA") and e.key not in spans), key=dev_us, reverse=True
    )
    total_ms = sum(dev_us(e) for e in kernels) / 1e3
    with open(os.path.join(out_dir, f"{label}.txt"), "w") as f:
        f.write(f"{label}: wall {wall_s * 1e3:.3f} ms, device {total_ms:.3f} ms [{card}]\n")
        f.write(events.table(sort_by=key, row_limit=60))
    busy = total_ms / (wall_s * 1e3) if wall_s > 0 else float("nan")
    top = "; ".join(f"{e.key[:60]} {dev_us(e) / 1e3:.2f} ms x{e.count}" for e in kernels[:6])
    print(f"profile {label}: wall {wall_s * 1e3:.2f} ms, device {total_ms:.2f} ms (busy {busy:.1%}); {top}")


def check_batch_against_cpu(torch, trainer, td, train_ds, config, card):
    """One BPR + InfoNCE batch on the card and on the CPU, from the same
    parameters, graphs and batch: the loss and every ``rec`` gradient."""
    from genmmrec_tpu_torch.data.arrays import build_train_data, sample_negatives
    from genmmrec_tpu_torch.models.diffmm import DiffMM

    model, dev, cpu = trainer.model, td.device, torch.device("cpu")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    B = trainer.train_batch_size
    idx = torch.randperm(td.n_inter, generator=gen, device=dev)[:B]
    users, pos = td.users[idx], td.items[idx]
    neg = sample_negatives(users, td.hist, td.item_pool, td.n_pool, trainer.neg_rounds, gen)
    weight = torch.ones(B, device=dev)
    weight[-B // 8 :] = 0.0  # a padded tail, as the epoch's last batch has
    batch = {"users": users, "pos": pos, "neg": neg, "weight": weight}
    cpu_model = DiffMM(config, build_train_data(train_ds, cpu))
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu_state = {k: g.to(cpu) for k, g in trainer.state.items()}
    rec_names = {id(p) for p in model.param_groups()["rec"]}

    def loss_and_grads(m, state, b):
        m.zero_grad(set_to_none=True)
        with torch.enable_grad():
            total, _ = m.loss(state, b)
            total.backward()
        names = [n for n, p in model.named_parameters() if id(p) in rec_names]
        params = dict(m.named_parameters())
        return total.item(), {n: params[n].grad.detach().cpu() for n in names}

    t0 = time.perf_counter()
    loss_gpu, g_gpu = loss_and_grads(model, trainer.state, batch)
    loss_cpu, g_cpu = loss_and_grads(cpu_model, cpu_state, {k: v.cpu() for k, v in batch.items()})
    model.zero_grad(set_to_none=True)
    rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    worst = {}
    for n, ref in g_cpu.items():
        diff = (g_gpu[n] - ref).abs()
        bound = GRAD_RTOL * ref.abs() + GRAD_ATOL * ref.abs().max()
        worst[n] = float((diff / bound.clamp(min=1e-30)).max())
    print(
        f"card vs CPU, one batch of {B}: loss {loss_gpu:.7f} vs {loss_cpu:.7f} (rel {rel:.2e}, "
        f"bound {LOSS_RTOL:.0e}); rec gradients, largest share of the bound per tensor "
        f"{json.dumps({k: round(v, 4) for k, v in worst.items()})} in {time.perf_counter() - t0:.1f} s [{card}]"
    )
    if not math.isfinite(loss_gpu) or rel > LOSS_RTOL:
        raise AssertionError(f"batch loss on the card {loss_gpu} differs from the CPU's {loss_cpu}")
    bad = [n for n, v in worst.items() if not v <= 1.0]
    if bad:
        raise AssertionError(f"rec gradients on the card differ from the CPU's: {bad}")
    return dict(loss_rel_err=rel, grad_bound_share=max(worst.values()))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1

    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", metavar="DIR", help="profile one more epoch, phase by phase, into DIR")
    args = parser.parse_args()

    from genmmrec_tpu_torch.config import Config
    from genmmrec_tpu_torch.data.arrays import build_eval_data, build_train_data
    from genmmrec_tpu_torch.data.dataset import RecDataset
    from genmmrec_tpu_torch.engine.diffusion_trainers import DiffMMTrainer
    from genmmrec_tpu_torch.engine.evaluator import group_masks
    from genmmrec_tpu_torch.engine.trainer import full_precision_matmuls
    from genmmrec_tpu_torch.models.diffmm import DiffMM
    from genmmrec_tpu_torch.ops import _build
    from genmmrec_tpu_torch.ops.topk import grouped_topk_plain

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
    k1_bwd = check_k1_backward(
        torch,
        [
            ("adjacency_d128", model.norm_adj, 2 * model.latdim),
            ("adjacency_d192", model.norm_adj, 3 * model.latdim),
            ("regenerated_modal_graph_d128", modal, 2 * model.latdim),
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

    # -- phase 3: the serving path ----------------------------------------
    reset_counts()
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
    serving_launches = launch_counts()
    print(f"regenerate: {t_regen:.3f} s; evaluate(valid): {t_valid:.3f} s; evaluate(test): {t_test:.3f} s [{card}]")
    print(f"launches during the serving path: {serving_launches}")
    print(f"valid: {json.dumps(valid_res)}")
    print(f"test: {json.dumps(test_res)}")
    for name in ("segment_spmm", "grouped_topk"):
        if serving_launches[name] <= 0:
            raise AssertionError(f"{name} was not launched during the serving path")
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

    # -- phase 4: the training path ---------------------------------------
    # two epochs as fit runs them, from the weights above: epoch 0 warms up,
    # epoch 1 is the measured one; then evaluate(valid)
    train_t0 = time.perf_counter()
    trainer._build_train_step(td)
    reset_counts()
    epochs = []
    for epoch in range(2):
        epochs.append(train_epoch(torch, trainer, epoch, card))
    t0 = time.perf_counter()
    train_valid = trainer.evaluate(vd)
    t_train_valid = time.perf_counter() - t0
    training_launches = {
        k: sum(e[f"{phase}_launches"][k] for e in epochs for phase in ("prelude", "bpr"))
        for k in serving_launches
    }
    print(f"after training, evaluate(valid): {t_train_valid:.3f} s: {json.dumps(train_valid)}")
    print(f"launches during the training path: {training_launches}")
    bad = [k for k, v in train_valid.items() if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"valid after training: non-finite metrics {bad}")
    batch_check = check_batch_against_cpu(torch, trainer, td, train_ds, config, card)
    print(f"training path checks done in {time.perf_counter() - train_t0:.1f} s")
    if args.profile:
        train_epoch(torch, trainer, 2, card, profile_dir=args.profile)

    launches = {k: serving_launches[k] + training_launches[k] for k in serving_launches}
    kernels = [
        dict(
            name="segment_spmm", route="cuda", source="genmmrec_tpu_torch/csrc/segment_sum.cu",
            replaces="genmmrec_tpu/ops/segment_pallas.py:395", launches=launches["segment_spmm"], **k1,
        ),
        dict(
            name="segment_spmm_backward", route="cuda", source="genmmrec_tpu_torch/csrc/segment_sum.cu",
            replaces="genmmrec_tpu/ops/segment_pallas.py:395 (from _sym_bwd :442)",
            launches=launches["segment_spmm_backward"], **k1_bwd,
        ),
        dict(
            name="grouped_topk", route="cuda", source="genmmrec_tpu_torch/csrc/topk.cu",
            replaces="genmmrec_tpu/ops/topk.py:135", launches=launches["grouped_topk"], **k3,
        ),
    ]
    strip = lambda e: {k: v for k, v in e.items() if not k.endswith("_launches")}
    summary = dict(
        regenerate_s=t_regen, eval_valid_s=t_valid, eval_test_s=t_test,
        train_epochs=[strip(e) for e in epochs], train_eval_valid_s=t_train_valid,
        launches_serving=serving_launches, launches_training=training_launches,
        batch_vs_cpu=batch_check, card=card,
    )
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
