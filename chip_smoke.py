#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (genmmrec_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]
    python3 chip_smoke.py --k5a-against DIR [DIR ...]

Drives DiffMM, GenRecV1 and LightGCN at full width, parameters from a
seeded generator.

DiffMM on Amazon-baby (19,445 users x 7,050 items, the synthetic fallback
data), through three paths of the port:

- serving: regenerate the two modal user-item graphs, then evaluate the
  valid split and the test split with the full metric set; then regenerate
  once more with ``GENMMREC_PALLAS_TOPK`` set, so that the top-1 of each
  user takes the two-stage route (K4 at kp = k = 1), and hold its graphs
  equal to the first ones;
- bf16 evaluation: the same parameters with ``eval_dtype: bfloat16``:
  regenerate, evaluate(valid) and evaluate(test) through the fused
  score + mask + top-k (K5a, K5b, K3 on bfloat16 rows), then evaluate(valid)
  with the candidates masked outside the kernel (K5c) and once more with the
  mask budget lowered, so that the per-chunk scatter route runs;
- training: two epochs (the first a warm-up), each the denoisers' phase 1,
  the regeneration and the BPR + InfoNCE epoch, then evaluate(valid); one
  batch's loss and ``rec`` gradients are then held against the same batch on
  the CPU.

LightGCN at the Amazon-elec geometry (192,403 users x 63,001 items,
embedding 64, two layers; interactions drawn in bulk from the dataset
generator's distributions at the sizes of the elec dataset tier), through
``get_model`` and ``Trainer``: 40 training batches of 2,048, whose
propagations run K2 forward and backward on the 255,404-row adjacency, then
evaluate(valid) three ways: float32 (K3), float32 with
``GENMMREC_PALLAS_TOPK`` set (the two-stage route, K4) and bfloat16 (the
fused route, K5); one batch against the CPU.

LightGCN at embedding width 192 on the DiffMM paths' baby data, wider than
the fused kernels: evaluate(valid) in float32 and in bfloat16, which takes
the plane route (bfloat16 scores, K3 with the packed mask), and a
scores-only view of the float32 model, scored chunk by chunk.

GenRecV1 on Amazon-baby at its published width (embedding 64, one layer,
a 6-layer ModalDenoise of width 512 over the 7,050 items, ``gen_topk`` 5,
``rebuild_k`` 10, ``knn_k`` 10, interest debiasing with baby's cluster
counts), through ``get_model`` and ``get_trainer``: the set-up (adjacency,
R, the two KNN graphs, the clustering) timed apart; K3 on its KNN rows
(7,050 x 7,050, k = 10) and on the regeneration's (2,048 x 7,050) planes at
k = 5 and 10, K1 forward on both KNN graphs, R at d = 128 and the generated
graph, K1's backward over the transposed CSR of the image KNN graph and of
R, each against its plain version; two epochs of its three phases; one
batch against the CPU (dropout masks injected; the CPU takes each
``leaky_relu`` entry's branch as the card took it); evaluate(valid) and
evaluate(test) in float32 (K3) and bfloat16 (K5).

Before the paths it builds the CUDA kernels from ``genmmrec_tpu_torch/csrc``
and holds each one (K1 forward and backward, K2 forward and backward, K3,
K4, K5a, K5b, K5c) against its plain PyTorch version, on the card, at the
shapes the paths give it, and times kernel, plain version and the one
PyTorch call that computes the same function with CUDA events. K1 and K2
are also held against each other on the same graphs and, bit for bit,
against the plain version on integer operands at every team shape; K2's
backward runs at d = 64 (the path's width) and 128; K3 also
runs the Amazon-elec catalog width in float32 and bfloat16, k = 65, 100,
256, 257 and 1,000 (its radix path) and a block of adversarial rows
(constant, tied at the threshold, fewer finite scores than k); K4 also runs
k = 100 and 200 (more groups than it keeps in shared memory), each case with the masked group maxima kernel and K3's choice of
groups against their plain versions and the fold's and the switched
route's times, and a block of adversarial rows at the elec width (every
candidate masked, constant, integer-valued ties, NaNs and zeros of both
signs, fewer finite scores than k; kp = k (odd kp too), kp > k (up to 448), kp < k, k past the
candidate buffer; pad slots and the ragged last group), the fold checked on
the same rows; K5b and K5c also run adversarial choices of groups (every row the
same groups, all pad slots, one group chosen by every row) and their plan
against its plain version; the fused top-k also runs k = 100 against the
plane route; ``spmm`` on a graph that is not symmetric is differentiated
on the card against the plain version, and ``spmm`` and ``spmm_t`` of the
baby adjacency with its edges shuffled (not row-sorted) against the plain
scatter. Each
kernel's time stands beside its bound: the larger of the bytes it must move
over the card's memory rate and its operations over the card's peak rate.
``--profile DIR`` adds one more bf16 evaluate(valid) and one more DiffMM
and GenRecV1 epoch, phase by phase, under ``torch.profiler`` and writes the
kernel tables to DIR. ``--k5a-against DIR ...`` does none of the above: it times this
checkout's K5a against the K5a of each other checkout (say an earlier
commit from ``git archive``), built from its own sources, in turns on the
same inputs.

It fails (non-zero exit, no result line) when no CUDA device is present, a
kernel does not build, launch or agree, a kernel of a path was not launched
during that path, a loss or a metric is not finite, a phase changed
parameters it does not train, the evaluation routes disagree with each other
or stray from the float32 metrics, or the fused route allocates a score
plane. Its last line is one JSON object with ``"ok": true`` and the device;
the line before it holds the kernels' results as JSON, nine entries.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
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
# the batch check's KNN graphs, built on each device, must share this much
# of their edges; an entry whose pre-activation sits on other sides of 0 on
# the two devices must be within FLIP_RTOL of its tensor's largest
# magnitude (about 80 float32 ulps of it), and such entries at most
# FLIP_SHARE of all
CARD_GRAPH_SHARE = 0.99
FLIP_RTOL, FLIP_SHARE = 1e-5, 1e-5
# bf16 evaluation against the float32 evaluation of the same parameters:
# bfloat16 scores reorder near-ties only, so Recall@20 and NDCG@20 stay
# within the bound the JAX package's own test of its bf16 path uses.
BF16_METRIC_ATOL = 5e-3
# The card's published peaks (NVIDIA H100 SXM data sheet, dense rates), for
# each kernel's bound.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12  # tensor cores
F32_FLOPS = 67e12  # outside the tensor cores
# the Amazon-elec catalog width and positives a row of the kernel roofline
ELEC_ITEMS, ELEC_POSITIVES = 63001, 30
# a k past K3's threshold path (k <= 64): a configured top-100
WIDE_K = 100
# K4's adversarial (k, kp): kp = k as the route chooses (odd kp too, which
# moves the candidate buffer's offset in shared memory; DiffMM's top-1),
# kp > k, kp past the 128 groups whose keys K4 keeps in shared memory,
# kp < k, k past the candidate buffer
K4_ADVERSARIAL_CASES = (
    (1, 1), (2, 2), (7, 7), (25, 25), (50, 50), (100, 100), (7, 25), (50, 80), (100, 40), (600, 10), (50, 200),
    (300, 448),
)
# a k whose kp = k groups are more than K4 keeps in shared memory (128)
UNSTAGED_K = 200


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


def graph_ms(torch, fn, iters: int = 20, replays: int = 5) -> float:
    """Mean milliseconds per call with the host out of the way: ``iters``
    calls captured into one CUDA graph, replayed ``replays`` times between
    two events (a kernel shorter than the host's time per call reads as the
    host's time by ``cuda_ms``)."""
    fn()  # first launches set up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def timed_pair(torch, kernel_fn, plain_fn):
    """(kernel ms, plain ms), measured in turns: plain, kernel, kernel, plain."""
    p1 = cuda_ms(torch, plain_fn)
    k1 = cuda_ms(torch, kernel_fn)
    k2 = cuda_ms(torch, kernel_fn)
    p2 = cuda_ms(torch, plain_fn)
    return (k1 + k2) / 2, (p1 + p2) / 2


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class Bound:
    """The least time the card could take: each input read once and each
    output written once at the memory rate, or the operations at the peak
    rate of their type, whichever is larger. Adds up over cases."""

    def __init__(self):
        self.bytes_ms = self.ops_ms = 0.0

    def add(self, bytes_moved: float, ops: float, peak: float) -> dict:
        one = Bound()
        one.bytes_ms, one.ops_ms = bytes_moved / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
        self.bytes_ms += one.bytes_ms
        self.ops_ms += one.ops_ms
        return one.keys()

    def keys(self) -> dict:
        by = "bytes" if self.bytes_ms >= self.ops_ms else "operations"
        return dict(bound_ms=max(self.bytes_ms, self.ops_ms), bound_by=by)


def spmm_wrappers(blocked: bool):
    """(kernel name, forward wrapper, plain version, differentiable product,
    backward wrapper) of K1 or, with ``blocked``, K2, each taking (graph, x)."""
    from genmmrec_tpu_torch.ops import segment as S

    if blocked:
        return (
            "K2",
            lambda g, x: S.segment_spmm_blocked(g.row_ptr, g.rows, g.cols, g.vals, x, g.n_rows),
            lambda g, x: S.segment_spmm_blocked_plain(g.rows, g.cols, g.vals, x, g.n_rows),
            lambda g, x: S.spmm_symmetric(g.row_ptr, g.rows, g.cols, g.vals, x, g.n_rows, blocked=True),
            lambda g, x: S.segment_spmm_blocked_backward(g.row_ptr, g.rows, g.cols, g.vals, x, g.n_rows),
        )
    return (
        "K1",
        lambda g, x: S.segment_spmm(g.row_ptr, g.cols, g.vals, x, g.n_rows, g.long_rows),
        lambda g, x: S.segment_spmm_plain(g.row_ptr, g.cols, g.vals, x, g.n_rows),
        lambda g, x: S.spmm_symmetric(g.row_ptr, g.rows, g.cols, g.vals, x, g.n_rows, long_rows=g.long_rows),
        lambda g, x: S.segment_spmm_backward(g.row_ptr, g.cols, g.vals, x, g.n_rows, g.long_rows),
    )


def check_spmm(torch, graphs, card, blocked: bool = False):
    """K1 or, with ``blocked``, K2 against its plain version on each (name,
    graph, d) case, and against the other kernel on the same graph: both are
    deterministic sums of the same terms in another order, so their largest
    difference and the other kernel's time there are reported (both
    kernels' times on both kinds of graph, for the choice of a graph's
    kernel)."""
    kname, kernel, plain, _, _ = spmm_wrappers(blocked)
    other_name, other_kernel, _, _, _ = spmm_wrappers(not blocked)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases, err, ms, plain_ms, lib_ms, bound = [], 0.0, 0.0, 0.0, 0.0, Bound()
    for name, g, d in graphs:
        x = torch.randn(g.n_cols, d, generator=gen, device="cuda")
        out = kernel(g, x)
        ref = plain(g, x)
        magnitude = plain(dataclasses.replace(g, vals=g.vals.abs()), x.abs())
        # the library's yardstick: one sparse product on a CSR tensor
        csr = torch.sparse_csr_tensor(
            g.row_ptr, g.cols, g.vals, size=(g.n_rows, g.n_cols), check_invariants=False
        )
        lib = torch.sparse.mm(csr, x)
        torch.cuda.synchronize()
        diff = (out - ref).abs()
        e = diff.max().item()
        if not bool((diff <= K1_RTOL * magnitude + K1_ATOL).all()):
            raise AssertionError(f"{kname} {name}: kernel and plain version differ by up to {e:.3e}")
        if not bool(((out - lib).abs() <= K1_RTOL * magnitude + K1_ATOL).all()):
            raise AssertionError(f"{kname} {name}: kernel and torch.sparse.mm differ")
        if not torch.equal(kernel(g, x), out):
            raise AssertionError(f"{kname} {name}: two launches on the same input differ")
        del ref, lib, diff
        apart = (out - other_kernel(g, x)).abs()
        if not bool((apart <= K1_RTOL * magnitude + K1_ATOL).all()):
            raise AssertionError(f"{kname} {name}: K1 and K2 differ by up to {apart.max().item():.3e}")
        other_diff, other_ms = apart.max().item(), cuda_ms(torch, lambda: other_kernel(g, x))
        del magnitude, apart
        k_ms, p_ms = timed_pair(torch, lambda: kernel(g, x), lambda: plain(g, x))
        l_ms = cuda_ms(torch, lambda: torch.sparse.mm(csr, x))
        b = bound.add(nbytes(g.row_ptr, g.cols, g.vals, x, out), 2.0 * g.nnz * d, F32_FLOPS)
        max_row = int((g.row_ptr[1:] - g.row_ptr[:-1]).max())
        # every edge gathers its own row of x: what the kernel really moves
        gather_tb_s = g.nnz * d * 4 / (k_ms * 1e-3) / 1e12
        print(
            f"{kname} {name}: n_rows={g.n_rows} nnz={g.nnz} longest_row={max_row} d={d} max_abs_err={e:.3e} repeatable, "
            f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, torch.sparse.mm {l_ms:.4f} ms, {other_name} on the same "
            f"graph {other_ms:.4f} ms (largest difference {other_diff:.3e}), bound {b['bound_ms']:.4f} ms ({b['bound_by']}); "
            f"the gathered rows at {gather_tb_s:.2f} TB/s [{card}]"
        )
        cases.append(dict(
            case=name, n_rows=g.n_rows, nnz=g.nnz, longest_row=max_row, d=d, max_abs_err=e,
            ms=k_ms, plain_ms=p_ms, library_ms=l_ms, other_kernel=other_name, other_kernel_ms=other_ms,
            max_abs_diff_other_kernel=other_diff, gather_tb_s=gather_tb_s, **b,
        ))
        err, ms, plain_ms, lib_ms = max(err, e), ms + k_ms, plain_ms + p_ms, lib_ms + l_ms
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, **bound.keys(), cases=cases)


def check_spmm_widths(torch, dev):
    """Both SpMM kernels' other team shapes (8, 16 and 32 lanes; 1, 2 and 4
    vectors a lane) on a small ragged graph: 3,000 rows with bands of empty
    rows at the start, in the middle and at the end, one row of 5,000 edges
    (forty of K2's chunks, a cluster's row in K1, beside rows of a few
    hundred edges that one block of K1 sums; two rows sit at the threshold of
    K1's list of long rows and one edge over it), an edge count that is no multiple of the chunk.
    Integer-valued operands, so every order of summation gives the same
    float32: forward and x-gradient equal to the plain version bit for bit."""
    import numpy as np

    from genmmrec_tpu_torch.ops.graph import sorted_graph
    from genmmrec_tpu_torch.ops.segment import LONG_ROW

    rng = np.random.default_rng(SEED + 6)
    n_rows, n_cols = 3000, 700
    live = np.concatenate([np.arange(40, 1200), np.arange(1500, 2900)])
    rows = np.sort(np.concatenate([
        rng.choice(live[live > 60], 20001), np.full(5000, 1777), np.full(300, 1778), np.full(777, 2899),
        np.full(LONG_ROW, 50), np.full(LONG_ROW + 1, 51),
    ]))
    cols = rng.integers(0, n_cols, rows.shape[0])
    vals = rng.integers(-2, 3, rows.shape[0]).astype(np.float32)
    to = lambda a: torch.as_tensor(a, device=dev)
    g = sorted_graph(to(rows), to(cols), to(vals), n_rows, n_cols)
    # the same edges as a square graph flagged symmetric: the backward is
    # then K2 on the cotangent over these edges, whatever their values
    sym = sorted_graph(g.rows, g.cols, g.vals, n_rows, n_rows, symmetric=True)
    n_long = int((g.long_rows >= 0).sum())
    if n_long < 4:
        raise AssertionError(f"the ragged graph has {n_long} long rows; the check needs the 5000-edge row and others")
    widths = (4, 32, 36, 64, 128, 192, 256, 384, 512)
    for blocked in (False, True):
        kname, kernel, plain, product, _ = spmm_wrappers(blocked)
        for d in widths:
            x = to(rng.integers(-3, 4, (n_cols, d)).astype(np.float32))
            if not torch.equal(kernel(g, x), plain(g, x)):
                raise AssertionError(f"{kname} at d={d} on the ragged graph differs from the plain version")
            with torch.enable_grad():
                xs = to(rng.integers(-3, 4, (n_rows, d)).astype(np.float32)).requires_grad_()
                g_bar = to(rng.integers(-3, 4, (n_rows, d)).astype(np.float32))
                got = torch.autograd.grad(product(sym, xs), xs, g_bar)[0]
            if not torch.equal(got, plain(sym, g_bar)):
                raise AssertionError(f"{kname} backward at d={d} on the ragged graph differs from the plain version")
    print(
        f"K1 and K2 widths {', '.join(map(str, widths))} on a ragged graph ({n_rows} rows, nnz={g.nnz}, a row of 5000 "
        f"edges, {n_long} rows of more than {LONG_ROW}, bands of empty rows): forward and backward bit-equal to plain"
    )


def check_spmm_backward(torch, graphs, card, blocked: bool = False):
    """The backward of K1 or, with ``blocked``, K2 (the x-gradient of
    ``spmm_symmetric``: the kernel on the output cotangent, as Aᵀ = A)
    against the gradient through the plain version's autograd, on each
    (name, graph, d) case. Each element is held to
    K1_RTOL · Σ|vals|·|ḡ[cols]| + K1_ATOL. Forward+backward is timed through
    autograd, as the trainer runs it, and as the two launches alone, which
    is what the library's two products are."""
    kname, forward, plain_fn, product, backward = spmm_wrappers(blocked)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    cases, err, ms, plain_ms, lib_ms, bound = [], 0.0, 0.0, 0.0, 0.0, Bound()
    with torch.enable_grad():
        for name, g, d in graphs:
            x = torch.randn(g.n_cols, d, generator=gen, device="cuda").requires_grad_()
            g_bar = torch.randn(g.n_rows, d, generator=gen, device="cuda")
            kernel = lambda: product(g, x)
            plain = lambda: plain_fn(g, x)
            grad = lambda fwd: torch.autograd.grad(fwd(), x, g_bar)[0]
            out, ref = grad(kernel), grad(plain)
            magnitude = plain_fn(dataclasses.replace(g, vals=g.vals.abs()), g_bar.abs())
            torch.cuda.synchronize()
            diff = (out - ref).abs()
            e = diff.max().item()
            if not bool((diff <= K1_RTOL * magnitude + K1_ATOL).all()):
                raise AssertionError(f"{kname} backward {name}: kernel and plain gradients differ by up to {e:.3e}")
            if not torch.equal(grad(kernel), out):
                raise AssertionError(f"{kname} backward {name}: two backward launches on the same input differ")
            k_ms, p_ms = timed_pair(torch, lambda: grad(kernel), lambda: grad(plain))
            # the backward alone, on a kept graph
            y_k, y_p = kernel(), plain()
            kb_ms, pb_ms = timed_pair(
                torch,
                lambda: torch.autograd.grad(y_k, x, g_bar, retain_graph=True),
                lambda: torch.autograd.grad(y_p, x, g_bar, retain_graph=True),
            )
            # the library's yardstick for forward+backward on a symmetric
            # graph (Aᵀ = A): the sparse product of x, then of the cotangent
            csr = torch.sparse_csr_tensor(
                g.row_ptr, g.cols, g.vals, size=(g.n_rows, g.n_cols), check_invariants=False
            )
            x_d = x.detach()
            with torch.no_grad():
                l_ms = cuda_ms(torch, lambda: (torch.sparse.mm(csr, x_d), torch.sparse.mm(csr, g_bar)))
                pair_ms = cuda_ms(torch, lambda: (forward(g, x_d), backward(g, g_bar)))
            b = bound.add(2 * nbytes(g.row_ptr, g.cols, g.vals, x, g_bar), 4.0 * g.nnz * d, F32_FLOPS)
            max_row = int((g.row_ptr[1:] - g.row_ptr[:-1]).max())
            print(
                f"{kname} backward {name}: n_rows={g.n_rows} nnz={g.nnz} longest_row={max_row} d={d} "
                f"max_abs_err={e:.3e} repeatable, forward+backward kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
                f"two torch.sparse.mm {l_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}); "
                f"the two launches without autograd {pair_ms:.4f} ms; "
                f"backward alone kernel {kb_ms:.4f} ms, plain {pb_ms:.4f} ms [{card}]"
            )
            cases.append(dict(
                case=name, n_rows=g.n_rows, nnz=g.nnz, longest_row=max_row, d=d, max_abs_err=e,
                ms=k_ms, plain_ms=p_ms, backward_ms=kb_ms, backward_plain_ms=pb_ms, library_ms=l_ms,
                launch_pair_ms=pair_ms, **b,
            ))
            err, ms, plain_ms, lib_ms = max(err, e), ms + k_ms, plain_ms + p_ms, lib_ms + l_ms
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, **bound.keys(), cases=cases)


def check_k3(torch, cases_in, card):
    """K3 against its plain version on each (name, scores, k, mask) case:
    indices equal, values equal where finite."""
    from genmmrec_tpu_torch.ops.topk import grouped_topk, grouped_topk_plain, unpack_mask

    cases, err, ms, plain_ms, lib_ms, bound = [], 0.0, 0.0, 0.0, 0.0, Bound()
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
        # the library's yardstick: masked_fill + torch.topk (the bool mask is
        # unpacked beforehand; topk's order among equal values is its own)
        excluded = None if m is None else unpack_mask(m, s.shape[1])
        lib = lambda: torch.topk(s if excluded is None else s.masked_fill(excluded, float("-inf")), k, dim=1)
        l_ms = cuda_ms(torch, lib)
        mask_bytes = 0 if m is None else s.shape[0] * -(-s.shape[1] // 8)
        b = bound.add(nbytes(s, v, i) + mask_bytes, float(s.numel()), F32_FLOPS)
        print(
            f"K3 {name}: scores {tuple(s.shape)} {str(s.dtype).split('.')[-1]} k={k} "
            f"mask={'yes' if m is not None else 'no'} indices equal, max_abs_err={e:.3e} kernel {k_ms:.4f} ms, "
            f"plain {p_ms:.4f} ms, torch.topk {l_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}) [{card}]"
        )
        cases.append(dict(
            case=name, shape=list(s.shape), dtype=str(s.dtype).split(".")[-1], k=k, max_abs_err=e,
            ms=k_ms, plain_ms=p_ms, library_ms=l_ms, **b,
        ))
        err, ms, plain_ms, lib_ms = max(err, e), ms + k_ms, plain_ms + p_ms, lib_ms + l_ms
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, **bound.keys(), cases=cases)


def check_k3_adversarial(torch, dev):
    """Rows that defeat K3's threshold, through the kernel: constant rows,
    ties at the threshold, more columns at the threshold than the
    candidate buffer holds, fewer than k finite scores, nothing finite, a
    mask that leaves fewer than k columns; at n = 100 (fewer columns than
    threads), 7,049 (rows on every alignment) and 63,001, float32 and
    bfloat16, k = 2, 50 and 64 (the threshold path) and 100 and 600 (the
    radix path, 600 in no order out of the kernel) where k <= n. Indices
    equal to the plain version's, values equal where finite."""
    import numpy as np

    from genmmrec_tpu_torch.ops.topk import grouped_topk, grouped_topk_plain

    rng = np.random.default_rng(SEED + 7)
    kinds = ("constant", "rounded", "half_tied_at_top", "seven_finite", "nothing_finite", "zeros_of_both_signs",
             "finite_at_the_end", "period_three", "masked_but_few", "gaussian")
    checked = 0
    for n in (100, 7049, ELEC_ITEMS):
        s = rng.standard_normal((3 * len(kinds), n)).astype(np.float32)
        dense = np.zeros(s.shape, bool)
        for r in range(s.shape[0]):
            kind = kinds[r % len(kinds)]
            if kind == "constant":
                s[r] = s[r, 0]
            elif kind == "rounded":
                s[r] = np.round(s[r])
            elif kind == "half_tied_at_top":
                s[r, rng.permutation(n)[: n // 2]] = 6.0
            elif kind == "seven_finite":
                s[r, rng.permutation(n)[7:]] = -np.inf
            elif kind == "nothing_finite":
                s[r] = -np.inf
            elif kind == "zeros_of_both_signs":
                s[r] = -np.abs(s[r])
                s[r, n // 10 : n // 2] = 0.0
                s[r, n // 10 : n // 2 : 2] = -0.0
            elif kind == "finite_at_the_end":
                s[r, : n - 3] = -np.inf
            elif kind == "period_three":
                s[r] = np.arange(n) % 3
            elif kind == "masked_but_few":
                dense[r, rng.permutation(n)[r % 60 :]] = True
        mask = torch.as_tensor(np.packbits(dense, axis=1, bitorder="little"), device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            scores = torch.as_tensor(s, device=dev).to(dtype)
            for k in (k for k in (2, 50, 64, 100, 600) if k <= n):
                v, i = grouped_topk(scores, k, packed_mask=mask)
                v_ref, i_ref = grouped_topk_plain(scores, k, packed_mask=mask)
                torch.cuda.synchronize()
                if not torch.equal(i, i_ref):
                    bad = [kinds[r % len(kinds)] for r in (i != i_ref).any(dim=1).nonzero().flatten().tolist()]
                    raise AssertionError(f"K3 adversarial rows, n={n} {dtype} k={k}: indices differ on {bad}")
                fin = torch.isfinite(v_ref)
                if not (torch.equal(v[fin], v_ref[fin]) and torch.equal(torch.isfinite(v), fin)):
                    raise AssertionError(f"K3 adversarial rows, n={n} {dtype} k={k}: values differ")
                checked += scores.shape[0]
    print(
        f"K3 adversarial rows ({', '.join(kinds)}) at n = 100, 7049 and {ELEC_ITEMS}, float32 and bfloat16, "
        f"k = 2, 50, 64, 100, 600: {checked} rows, indices equal to plain, values equal where finite"
    )


def same_values(a, b) -> bool:
    """Equal element by element, a NaN equal to a NaN (-0 equals +0)."""
    return a.shape == b.shape and bool(((a == b) | (a.isnan() & b.isnan())).all())


def check_fold(torch, s, m, what):
    """The masked group maxima kernel against its plain version, after
    ``+ 0.0`` (a zero maximum may come out as -0 from the plain version), a
    NaN equal to a NaN. Returns the maxima."""
    from genmmrec_tpu_torch.ops import topk as T

    gmax = T.masked_group_max(s, m)
    ref = T.masked_group_max_plain(s, m)
    if not same_values(gmax + 0.0, ref + 0.0) or gmax.dtype != torch.float32:
        raise AssertionError(f"{what}: the masked group maxima differ from the plain version")
    return gmax


def check_k4(torch, b, n, k, per_row, card):
    """K4 at the evaluation's shape: (b, n) float32 and bfloat16 scores, with
    and without a packed mask of ``per_row`` positives a row, the groups
    chosen as the switched ``grouped_topk`` chooses them (the masked group
    maxima kernel, then K3 on the maxima), each step against its plain
    version. Indices equal to the plain version's and to K3's on the same
    rows, values equal; the switched route equal to K3 too; then pad slots
    and a nearly empty row against the plain version. Times K4, the fold
    (``fold_ms``; its yardstick ``fold_library_ms``: masked_fill, pad, amax)
    and the switched route whole (``route_ms``)."""
    from genmmrec_tpu_torch.ops import topk as T

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    packed = elec_mask(torch, b, n, per_row, SEED + 4, dev)
    ng = -(-n // 128)
    kp = min(k, ng)
    cases, ms, plain_ms, lib_ms, fold_ms, route_ms, bound = [], 0.0, 0.0, 0.0, 0.0, 0.0, Bound()

    def switched():
        os.environ["GENMMREC_PALLAS_TOPK"] = "1"
        try:
            return T.grouped_topk(s, k, m)
        finally:
            del os.environ["GENMMREC_PALLAS_TOPK"]

    for dtype in (torch.float32, torch.bfloat16):
        s = torch.randn(b, n, generator=gen, device=dev).to(dtype)
        for m in (None, packed):
            name = f"eval_top{k}_{str(dtype).split('.')[-1]}_{'masked' if m is not None else 'unmasked'}"
            gmax = check_fold(torch, s, m, f"K4 {name}")
            gidx = T.choose_groups(gmax, kp)
            if not torch.equal(gidx, T.choose_groups_by_sort(gmax, kp)):
                raise AssertionError(f"K4 {name}: K3's choice of groups differs from the plain sort")
            v, i = T.candidate_extract(s, gidx, k, m)
            v_ref, i_ref = T.candidate_extract_plain(s, gidx, k, m)
            v3, i3 = T.grouped_topk(s, k, m)
            v_sw, i_sw = switched()
            torch.cuda.synchronize()
            for what, (vv, ii) in {"the plain version": (v_ref, i_ref), "K3": (v3, i3), "the switched route": (v_sw, i_sw)}.items():
                if not torch.equal(i, ii):
                    bad = (i != ii).any(dim=1).sum().item()
                    raise AssertionError(f"K4 {name}: indices differ from {what} in {bad} rows")
                if not torch.equal(v, vv):
                    raise AssertionError(f"K4 {name}: values differ from {what}")
            if not torch.equal(T.candidate_extract(s, gidx, k, m)[1], i):
                raise AssertionError(f"K4 {name}: two launches on the same input differ")
            # pad slots (a group id of n_groups and one below 0), a row with
            # two live items, and a row whose only real group is the ragged
            # last one: its list ends in (-inf, -1)
            rows = slice(0, 256)
            g_pad = gidx[rows].clone()
            g_pad[:, -1] = ng
            g_pad[::2, 0] = -1
            m_few = (packed if m is None else m)[rows].clone()
            m_few[0] = 0xFF
            m_few[0, 0] = 0xFC
            g_pad[0, 0] = 0
            g_pad[1] = ng
            g_pad[1, 0] = ng - 1
            got = T.candidate_extract(s[rows].contiguous(), g_pad, k, m_few)
            want = T.candidate_extract_plain(s[rows].contiguous(), g_pad, k, m_few)
            if not (torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])):
                raise AssertionError(f"K4 {name}: pad slots or a nearly empty row differ from the plain version")
            if n - (ng - 1) * 128 < k and got[1][1, -1].item() != -1:
                raise AssertionError(f"K4 {name}: a row that ran out of real candidates lists a pad entry")
            k_ms, p_ms = timed_pair(
                torch, lambda: T.candidate_extract(s, gidx, k, m), lambda: T.candidate_extract_plain(s, gidx, k, m)
            )
            f_ms, fp_ms = timed_pair(torch, lambda: T.masked_group_max(s, m), lambda: T.masked_group_max_plain(s, m))
            # the fold's yardstick: masked_fill (with a mask), the pad to whole
            # groups, amax over the (b, n_groups, 128) view
            excluded = None if m is None else T.unpack_mask(m, n)
            fl_ms = cuda_ms(torch, lambda: torch.nn.functional.pad(
                s if excluded is None else s.masked_fill(excluded, float("-inf")), (0, ng * 128 - n),
                value=float("-inf")).view(b, ng, 128).amax(dim=2))
            r_ms = cuda_ms(torch, switched)
            lib = lambda: torch.topk(s if excluded is None else s.masked_fill(excluded, float("-inf")), k, dim=1)
            l_ms = cuda_ms(torch, lib)
            k3_ms = cuda_ms(torch, lambda: T.grouped_topk(s, k, m))
            # the chosen groups' scores and mask bytes, the group ids, the outputs
            moved = b * kp * 128 * s.element_size() + (0 if m is None else b * kp * 16) + nbytes(gidx, v, i)
            bnd = bound.add(moved, float(b * kp * 128), F32_FLOPS)
            # the fold: the whole plane and its mask once, the maxima written
            fold_bnd = Bound().add(nbytes(s, gmax) + (0 if m is None else b * -(-n // 8)), float(b * n), F32_FLOPS)
            print(
                f"K4 {name}: scores {tuple(s.shape)} kp={kp} k={k} indices and values equal to plain, K3 and the "
                f"switched route; group maxima and K3's choice of groups equal to plain; kernel {k_ms:.4f} ms, "
                f"plain {p_ms:.4f} ms, masked_fill + torch.topk of the whole row {l_ms:.4f} ms, K3 on the whole row "
                f"{k3_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}); the fold {f_ms:.4f} ms, plain "
                f"{fp_ms:.4f} ms, masked_fill + pad + amax {fl_ms:.4f} ms, bound {fold_bnd['bound_ms']:.4f} ms; the switched "
                f"route whole {r_ms:.4f} ms [{card}]"
            )
            cases.append(dict(
                case=name, shape=list(s.shape), dtype=str(dtype).split(".")[-1], k=k, kp=kp, max_abs_err=0.0,
                ms=k_ms, plain_ms=p_ms, library_ms=l_ms, k3_ms=k3_ms, fold_ms=f_ms, fold_plain_ms=fp_ms, fold_library_ms=fl_ms,
                fold_bound_ms=fold_bnd["bound_ms"], route_ms=r_ms, **bnd,
            ))
            ms, plain_ms, lib_ms = ms + k_ms, plain_ms + p_ms, lib_ms + l_ms
            fold_ms, route_ms = fold_ms + f_ms, route_ms + r_ms
        del s
    return dict(
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, fold_ms=fold_ms, route_ms=route_ms,
        **bound.keys(), cases=cases,
    )


def check_k4_adversarial(torch, dev):
    """Rows that defeat K4's threshold, through the kernel, at the elec
    width: every candidate masked, constant rows, integer-valued rows tied
    at the threshold, NaNs and zeros of both signs, fewer than k finite
    scores, Gaussian rows; float32 and bfloat16; groups as the route
    chooses them (kp = k = 1, 2, 7, 25, 50, 100, odd kp among them; kp > k up to 448 groups, past the 128
    whose keys K4 keeps in shared memory), fewer groups than k
    (kp < k: the radix select), k past the candidate buffer (ordered by the
    wrapper), and the same groups with pad slots and the ragged last group
    put in. The fold against its plain version on the same rows; K4's
    indices equal to the plain version's, values equal (a NaN to a NaN);
    where the route's groups hold the top-k, equal to K3 on the whole row
    and, for kp = k, to the switched route."""
    import numpy as np

    from genmmrec_tpu_torch.ops import topk as T

    rng = np.random.default_rng(SEED + 8)
    n = ELEC_ITEMS
    ng = -(-n // 128)
    kinds = ("all_masked", "constant", "integer_tied", "nan_and_zeros", "seven_finite", "gaussian")
    s = rng.standard_normal((4 * len(kinds), n)).astype(np.float32)
    dense = np.zeros(s.shape, bool)
    for r in range(s.shape[0]):
        kind = kinds[r % len(kinds)]
        dense[r, rng.permutation(n)[:30]] = True
        if kind == "all_masked":
            dense[r] = True
        elif kind == "constant":
            s[r] = 0.5
        elif kind == "integer_tied":
            s[r] = np.round(s[r] * 2)
        elif kind == "nan_and_zeros":
            s[r] = -np.abs(s[r])
            s[r, rng.permutation(n)[:3]] = np.nan
            s[r, n // 3 : n // 2] = 0.0
            s[r, n // 3 : n // 2 : 2] = -0.0
        elif kind == "seven_finite":
            s[r, rng.permutation(n)[7:]] = -np.inf
    mask = torch.as_tensor(np.packbits(dense, axis=1, bitorder="little"), device=dev)
    checked = 0
    for dtype in (torch.float32, torch.bfloat16):
        scores = torch.as_tensor(s, device=dev).to(dtype)
        for m in (None, mask):
            gmax = check_fold(torch, scores, m, f"K4 adversarial rows {dtype}")
            for k, kp in K4_ADVERSARIAL_CASES:
                gidx = T.choose_groups(gmax, kp)
                padded = gidx.clone()
                padded[:, -1] = ng - 1 if kp > 1 else ng
                padded[::2, 0] = -1
                padded[1::4, kp // 2] = ng
                for label, g in (("route's groups", gidx), ("pad slots", padded.sort(dim=1).values)):
                    v, i = T.candidate_extract(scores, g, k, m)
                    v_ref, i_ref = T.candidate_extract_plain(scores, g, k, m)
                    torch.cuda.synchronize()
                    if not torch.equal(i, i_ref):
                        bad = [kinds[r % len(kinds)] for r in (i != i_ref).any(dim=1).nonzero().flatten().tolist()]
                        raise AssertionError(f"K4 adversarial rows, {dtype} k={k} kp={kp} {label}: indices differ on {bad}")
                    if not same_values(v, v_ref):
                        raise AssertionError(f"K4 adversarial rows, {dtype} k={k} kp={kp} {label}: values differ")
                    checked += scores.shape[0]
                if kp >= k:
                    v3, i3 = T.grouped_topk(scores, k, m)
                    v, i = T.candidate_extract(scores, gidx, k, m)
                    if not (torch.equal(i, i3) and same_values(v, v3)):
                        raise AssertionError(f"K4 adversarial rows, {dtype} k={k} kp={kp}: differs from K3 on the whole row")
                if kp == k:
                    os.environ["GENMMREC_PALLAS_TOPK"] = "1"
                    try:
                        v_sw, i_sw = T.grouped_topk(scores, k, m)
                    finally:
                        del os.environ["GENMMREC_PALLAS_TOPK"]
                    if not (torch.equal(i, i_sw) and same_values(v, v_sw)):
                        raise AssertionError(f"K4 adversarial rows, {dtype} k={k}: differs from the switched route")
    print(
        f"K4 adversarial rows ({', '.join(kinds)}) at n = {n}, float32 and bfloat16, masked and not, (k, kp) = "
        f"{', '.join(map(str, K4_ADVERSARIAL_CASES))} (past 128 groups the keys are not kept in shared memory), "
        f"with and without pad slots: {checked} rows, "
        f"indices equal to plain, values equal; equal to K3 on the whole row for kp >= k and to the switched route; "
        f"the fold (NaN, all-masked groups) equal to plain"
    )


def check_nonsymmetric_grad(torch, g, d, card, case="nonsymmetric_ui"):
    """``spmm`` of a sorted graph that is not symmetric, differentiated on
    the card: the x-gradient (K1 over the graph's transposed CSR) against the
    plain version's autograd, within K1_RTOL · Σ|vals|·|ḡ| + K1_ATOL, and
    bit-equal on a second run."""
    from genmmrec_tpu_torch.ops.graph import spmm
    from genmmrec_tpu_torch.ops.segment import segment_spmm, segment_spmm_backward, segment_spmm_plain

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    with torch.enable_grad():
        x = torch.randn(g.n_cols, d, generator=gen, device="cuda").requires_grad_()
        g_bar = torch.randn(g.n_rows, d, generator=gen, device="cuda")
        grad = lambda fwd: torch.autograd.grad(fwd(), x, g_bar)[0]
        kernel = lambda: spmm(g, x)
        out = grad(kernel)
        ref = grad(lambda: segment_spmm_plain(g.row_ptr, g.cols, g.vals, x, g.n_rows))
        t = g.transposed()
        magnitude = segment_spmm_plain(t.row_ptr, t.cols, t.vals.abs(), g_bar.abs(), t.n_rows)
        torch.cuda.synchronize()
        e = (out - ref).abs().max().item()
        if not bool(((out - ref).abs() <= K1_RTOL * magnitude + K1_ATOL).all()):
            raise AssertionError(f"non-symmetric spmm: x-gradient differs from the plain version's by up to {e:.3e}")
        if not torch.equal(grad(kernel), out):
            raise AssertionError("non-symmetric spmm: two backward runs differ")
        plain = lambda: segment_spmm_plain(g.row_ptr, g.cols, g.vals, x, g.n_rows)
        ms, plain_ms = timed_pair(torch, lambda: grad(kernel), lambda: grad(plain))
    # the library's yardstick: the sparse product of x, then of the cotangent
    # on the transposed CSR
    csr = torch.sparse_csr_tensor(g.row_ptr, g.cols, g.vals, size=(g.n_rows, g.n_cols), check_invariants=False)
    csr_t = torch.sparse_csr_tensor(t.row_ptr, t.cols, t.vals, size=(t.n_rows, t.n_cols), check_invariants=False)
    x_d = x.detach()
    lib_ms = cuda_ms(torch, lambda: (torch.sparse.mm(csr, x_d), torch.sparse.mm(csr_t, g_bar)))
    # and the same two products as K1's two launches alone
    with torch.no_grad():
        pair_ms = cuda_ms(torch, lambda: (
            segment_spmm(g.row_ptr, g.cols, g.vals, x_d, g.n_rows, g.long_rows),
            segment_spmm_backward(t.row_ptr, t.cols, t.vals, g_bar, t.n_rows, t.long_rows),
        ))
    b = Bound().add(
        nbytes(g.row_ptr, g.cols, g.vals, x, g_bar) + nbytes(t.row_ptr, t.cols, t.vals, g_bar, x),
        4.0 * g.nnz * d, F32_FLOPS,
    )
    longest = max(int((p.row_ptr[1:] - p.row_ptr[:-1]).max()) for p in (g, t))
    print(
        f"K1 backward {case}_d{d} ({g.n_rows} x {g.n_cols}, nnz={g.nnz}, longest row {longest}): x-gradient "
        f"over the transposed CSR max_abs_err={e:.3e} repeatable, forward+backward kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, two torch.sparse.mm {lib_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}); "
        f"the two launches without autograd {pair_ms:.4f} ms [{card}]"
    )
    return dict(case=f"{case}_d{d}", n_rows=g.n_rows, nnz=g.nnz, longest_row=longest, d=d, max_abs_err=e,
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms, launch_pair_ms=pair_ms, **b)


def check_unsorted_spmm(torch, g, d, card):
    """``spmm`` and ``spmm_t`` of a graph whose edges are not row-sorted (the
    baby adjacency's edges in a seeded random order, ``sorted=False``), on
    the card, through the graph's row-sorted view: forward and x-gradient
    against the plain scatter (``index_add_``, the reference's
    ``segment_sum(indices_are_sorted=False)``) within K1_RTOL · Σ|terms| +
    K1_ATOL; the view's order is kept with the graph."""
    from genmmrec_tpu_torch.ops.graph import spmm, spmm_t

    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    perm = torch.randperm(g.nnz, generator=gen, device="cuda")
    shuffled = dataclasses.replace(
        g, rows=g.rows[perm], cols=g.cols[perm], vals=g.vals[perm], sorted=False, long_rows=None,
        _transpose={}, _row_sort={},
    )
    scatter = lambda rows, cols, vals, x, n: torch.zeros(n, x.shape[1], device="cuda").index_add_(
        0, rows.long(), vals[:, None] * x[cols.long()])
    plain = lambda x: scatter(shuffled.rows, shuffled.cols, shuffled.vals, x, g.n_rows)
    plain_t = lambda x: scatter(shuffled.cols, shuffled.rows, shuffled.vals, x, g.n_cols)
    err = 0.0
    with torch.enable_grad():
        for what, fwd, ref_fn, n_in, n_out, mag_graph in (
            ("spmm", spmm, plain, g.n_cols, g.n_rows, (shuffled.rows, shuffled.cols)),
            ("spmm_t", spmm_t, plain_t, g.n_rows, g.n_cols, (shuffled.cols, shuffled.rows)),
        ):
            x = torch.randn(n_in, d, generator=gen, device="cuda").requires_grad_()
            g_bar = torch.randn(n_out, d, generator=gen, device="cuda")
            out = fwd(shuffled, x)
            ref = ref_fn(x)
            (x_bar,) = torch.autograd.grad(out, x, g_bar)
            (x_bar_ref,) = torch.autograd.grad(ref, x, g_bar)
            r, c = mag_graph
            magnitude = scatter(r, c, shuffled.vals.abs(), x.detach().abs(), n_out)
            magnitude_t = scatter(c, r, shuffled.vals.abs(), g_bar.abs(), n_in)
            torch.cuda.synchronize()
            for part, got, want, mag in (("forward", out, ref, magnitude), ("x-gradient", x_bar, x_bar_ref, magnitude_t)):
                diff = (got.detach() - want.detach()).abs()
                if not bool((diff <= K1_RTOL * mag + K1_ATOL).all()):
                    raise AssertionError(f"{what} of a shuffled graph: {part} differs from the plain scatter by up to "
                                         f"{diff.max().item():.3e}")
                err = max(err, diff.max().item())
    if not shuffled._row_sort or shuffled._transpose.get("perm") is None:
        raise AssertionError("the shuffled graph keeps no row-sorted view or transposed structure")
    x = torch.randn(g.n_cols, d, generator=gen, device="cuda")
    ms, plain_ms = timed_pair(torch, lambda: spmm(shuffled, x), lambda: plain(x))
    print(
        f"spmm and spmm_t of the shuffled baby adjacency ({g.n_rows} rows, nnz={g.nnz}, sorted=False) d={d}: "
        f"forward and x-gradient within the bound of the plain scatter, max_abs_err={err:.3e}; spmm {ms:.4f} ms "
        f"(the row-sorted view's gather and K1), plain scatter {plain_ms:.4f} ms [{card}]"
    )
    return dict(case=f"shuffled_adjacency_d{d}", n_rows=g.n_rows, nnz=g.nnz, d=d, max_abs_err=err, ms=ms,
                plain_ms=plain_ms)


def wide_embedding_path(torch, td, vd, config, card):
    """LightGCN at embedding width 192 on the baby data that the DiffMM paths
    load: ``evaluate(valid)`` in float32 (K3 on the plane) and in bfloat16,
    which takes the plane route (bfloat16 scores, K3 with the packed mask)
    because 192 is wider than the fused kernels' widest; its Recall@20 and
    NDCG@20 within BF16_METRIC_ATOL of float32's. Then a scores-only view of
    the float32 model (``scores`` alone, no ``full_embeddings``): the
    trainer scores it chunk by chunk, and its lists equal the cached
    route's. Returns (results, launches by call)."""
    from genmmrec_tpu_torch.config import Config
    from genmmrec_tpu_torch.engine.trainer import Trainer
    from genmmrec_tpu_torch.models import get_model
    from genmmrec_tpu_torch.models.base import RecModel

    over = {"save_recommended_topk": False, "embedding_size": 192, "n_layers": 2}
    res, launches, trainers = {}, {}, {}
    for dtype in ("float32", "bfloat16"):
        cfg = Config("LightGCN", "baby", {**over, "eval_dtype": dtype})
        cfg["pop_mask"], cfg["warm_mask"] = config["pop_mask"], config["warm_mask"]
        model = get_model("LightGCN")(cfg, td)
        model.init_params(torch.Generator(device=td.device).manual_seed(SEED))
        trainers[dtype] = Trainer(cfg, model)
        trainers[dtype]._dense_mask(vd)  # set-up, once per eval set
    if trainers["float32"].model.latent_dim != 192:
        raise AssertionError("the wide LightGCN is not 192 wide")

    def run(label, fn):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        res[f"{label}_s"] = time.perf_counter() - t0
        launches[label] = launch_counts()
        return out

    valid = {dtype: run(f"eval_valid_{dtype}", lambda tr=tr: tr.evaluate(vd)) for dtype, tr in trainers.items()}
    for label in ("eval_valid_float32", "eval_valid_bfloat16"):
        got = launches[label]
        if got["grouped_topk"] <= 0 or got["fused_group_max"] or got["fused_candidates"]:
            raise AssertionError(f"LightGCN/baby d=192 {label}: expected K3 on the plane and no K5: {got}")
    drift = {key: valid["bfloat16"][key] - valid["float32"][key] for key in ("recall@20", "ndcg@20")}
    off = {k: v for k, v in drift.items() if not abs(v) <= BF16_METRIC_ATOL}
    bad = [k for r in valid.values() for k, v in r.items() if not math.isfinite(v)]
    if off or bad:
        raise AssertionError(f"LightGCN/baby d=192: bf16 drift {off} or non-finite metrics {bad}")

    tr = trainers["float32"]
    model = tr.model
    base = type(model)

    class ScoresOnly(base):
        eval_artifacts = RecModel.eval_artifacts
        full_embeddings = RecModel.full_embeddings

        def scores(self, state, users):
            return base.scores_cached(self, state, users, base.full_embeddings(self, state))

    cached = tr.eval_topk(vd)
    model.__class__ = ScoresOnly
    try:
        scored = run("eval_topk_scores_only", lambda: tr.eval_topk(vd))
    finally:
        model.__class__ = base
    if not torch.equal(scored, cached):
        raise AssertionError("a scores-only view of LightGCN/baby gives other lists than the cached route")
    print(
        f"LightGCN/baby d=192 evaluate(valid): float32 {res['eval_valid_float32_s']:.3f} s, bfloat16 (plane route, "
        f"wider than the fused kernels) {res['eval_valid_bfloat16_s']:.3f} s, Recall@20 and NDCG@20 drift "
        f"{json.dumps({k: round(v, 6) for k, v in drift.items()})} (bound {BF16_METRIC_ATOL}); a scores-only view "
        f"scored chunk by chunk in {res['eval_topk_scores_only_s']:.3f} s, lists equal to the cached route's [{card}]"
    )
    print(f"LightGCN/baby d=192 launches: {json.dumps(launches)}")
    return dict(**res, valid_float32=valid["float32"], valid_bfloat16=valid["bfloat16"], metric_drift=drift), launches


def bf16_ordinal(torch, x):
    """bfloat16 values as integers in value order (both zeros at 0), so that
    two values one unit in the last place apart differ by 1."""
    bits = x.contiguous().view(torch.int16).to(torch.int32)
    return torch.where(bits < 0, -(bits & 0x7FFF), bits)


def check_topk_lists(torch, what, masked_plane, idx, idx_ref, n_items, rows=None):
    """A top-k index list against a reference list of the same masked
    bfloat16 plane, where the two may have rounded a score to either side of
    a bfloat16 boundary: no index out of the catalog or repeated within a
    row, none excluded, and a row's two lists differ only in items whose
    score in the plane lies within one ulp of that row's k-th. ``rows``
    selects the rows that count (all by default)."""
    if rows is not None:
        masked_plane, idx, idx_ref = masked_plane[rows], idx[rows], idx_ref[rows]
    if idx.min().item() < 0 or idx.max().item() >= n_items:
        raise AssertionError(f"{what}: an index lies outside the catalog")
    ordered = idx.sort(dim=1).values
    if bool((ordered[:, 1:] == ordered[:, :-1]).any()):
        raise AssertionError(f"{what}: an item is listed twice in a row")
    score = bf16_ordinal(torch, masked_plane.gather(1, idx))
    score_ref = bf16_ordinal(torch, masked_plane.gather(1, idx_ref))
    kth = score_ref[:, -1:]
    finite_k = torch.isfinite(masked_plane.gather(1, idx_ref[:, -1:]))
    if bool((torch.isinf(masked_plane.gather(1, idx)) & finite_k).any()):
        raise AssertionError(f"{what}: an excluded item is listed in a row that has k others")
    only_here = ~(idx[:, :, None] == idx_ref[:, None, :]).any(dim=2)
    only_ref = ~(idx_ref[:, :, None] == idx[:, None, :]).any(dim=2)
    far = (only_here & ((score - kth).abs() > 1) & finite_k) | (only_ref & ((score_ref - kth).abs() > 1) & finite_k)
    if bool(far.any()):
        raise AssertionError(f"{what}: the lists differ in an item more than one ulp from the k-th score")
    return float(only_here.float().mean())


def k5_operands(torch, b, n, d, exact: bool, seed: int, dev, span: int = 2):
    """(u, table) from numpy: integer entries in [-span, span] when ``exact``
    (every sum is an integer of magnitude <= span²·d, exact in bfloat16 in
    any order while that is at most 256), else standard normal."""
    import numpy as np

    rng = np.random.default_rng(seed)
    if exact:
        u, t = rng.integers(-span, span + 1, (b, d)), rng.integers(-span, span + 1, (n, d))
    else:
        u, t = rng.standard_normal((b, d), np.float32), rng.standard_normal((n, d), np.float32)
    return (torch.as_tensor(np.asarray(a, np.float32), device=dev) for a in (u, t))


def elec_mask(torch, b, n, per_row, seed, dev):
    """(b, n_groups·16) packed mask of ``per_row`` random positives a row,
    the columns past the catalog set."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_pad = -(-n // 128) * 128
    packed = np.zeros((b, n_pad // 8), np.uint8)
    cols = np.concatenate([rng.integers(0, n, (b, per_row)), np.tile(np.arange(n, n_pad), (b, 1))], axis=1)
    rows = np.repeat(np.arange(b), cols.shape[1])
    np.bitwise_or.at(packed, (rows, cols.reshape(-1) >> 3), (1 << (cols.reshape(-1) & 7)).astype(np.uint8))
    return torch.as_tensor(packed, device=dev)


def check_k5_widths(torch, k, dev):
    """The K5 kernels' other embedding widths (32, 128, and 40, which the
    wrapper pads to 64) on a small ragged shape: 300 rows (not a multiple of
    the 128-row user tile), 1,000 items (a last group of 104, fewer groups
    than k), one row fully masked and one nearly, one group fully masked in
    every row. Integer operands in {-1, 0, 1}: everything equal to the plain
    versions bit for bit."""
    from genmmrec_tpu_torch.ops import fused_topk as F
    from genmmrec_tpu_torch.ops.topk import grouped_topk_plain

    b, n = 300, 1000
    mask = elec_mask(torch, b, n, 20, SEED + 2, dev)
    mask[0] = 0xFF  # a row with nothing left: all -inf
    mask[1, 2:] = 0xFF  # a row with fewer items left than k: a -inf tail
    mask[:, 16 * 3 : 16 * 4] = 0xFF  # a group with nothing left in any row
    for d in (32, 40, 128):
        u32, t32 = k5_operands(torch, b, n, d, True, SEED + d, dev, span=1)
        u, t = u32.bfloat16(), t32.bfloat16()
        gmax = F.fused_group_max(u, t, mask)
        gidx = torch.sort(gmax, dim=1, descending=True, stable=True).indices[:, :5].to(torch.int32).contiguous()
        pairs = {
            "K5a": (gmax, F.fused_group_max_plain(u, t, mask)),
            "K5b": (F.fused_candidates(u, t, gidx, mask), F.fused_candidates_plain(u, t, gidx, mask)),
            "K5c": (F.fused_candidates_unmasked(u, t, gidx), F.fused_candidates_unmasked_plain(u, t, gidx)),
        }
        v, i = F.fused_grouped_topk(u32, t32, k, mask)
        v_ref, i_ref = grouped_topk_plain(F.score_plane(u, t), k, packed_mask=mask)
        torch.cuda.synchronize()
        for what, (out, ref) in pairs.items():
            if not torch.equal(out, ref):
                raise AssertionError(f"{what} at d={d}, {b} x {n}: kernel and plain version differ")
        if not (torch.equal(v, v_ref) and torch.equal(i, i_ref)):
            raise AssertionError(f"fused top-k at d={d}, {b} x {n} differs from the plane's top-k")
    print(f"K5 widths 32, 40 (padded to 64), 128 on {b} x {n} (a row and a group fully masked): K5a, K5b, K5c and "
          f"the fused top-k bit-equal to plain")


def check_k5a_edges(torch, F, n, d, mask):
    """K5a at the row counts the paths give it besides a full chunk (1, 63,
    and LightGCN/elec's last chunk of 3,708), then a row with every item
    excluded, a group with every item excluded and the catalog's ragged last
    group (63,001 = 492·128 + 25 items): every score negative there, so a
    pad column that scored its zero instead of being excluded by its mask
    bit would win its group. Integer operands: bit-equal to plain."""
    dev = mask.device
    for b in (1, 63, 3708):
        u, t = (x.bfloat16() for x in k5_operands(torch, b, n, d, True, SEED + b, dev))
        if not torch.equal(F.fused_group_max(u, t, mask[:b]), F.fused_group_max_plain(u, t, mask[:b])):
            raise AssertionError(f"K5a at b={b}, n={n}: kernel and plain version differ")
    b, ng = 256, F.n_groups_for(n)
    edge = mask[:b].clone()
    edge[0] = 0xFF  # a row with every item excluded
    edge[:, 16 * 7 : 16 * 8] = 0xFF  # group 7 excluded in every row
    u, t = (x.bfloat16() for x in k5_operands(torch, b, n, d, True, SEED + 7, dev, span=1))
    u, t = u.abs() + 1, -(t.abs() + 1)  # every score negative
    gmax = F.fused_group_max(u, t, edge)
    if not torch.equal(gmax, F.fused_group_max_plain(u, t, edge)):
        raise AssertionError(f"K5a edges at n={n}: kernel and plain version differ")
    if not (torch.isneginf(gmax[0]).all() and torch.isneginf(gmax[:, 7]).all()):
        raise AssertionError("K5a edges: a fully excluded row or group is not -inf")
    tail = gmax[1:, ng - 1].float()
    if n % 128 and not bool(((tail < 0) | torch.isneginf(tail)).all()):
        raise AssertionError("K5a edges: a pad column of the last group scored its zero")
    print(f"K5a b=1, 63, 3708 at n={n}, a fully excluded row and group, the last group of {n - (ng - 1) * 128} "
          f"items with every score negative: bit-equal to plain")


def check_plan(torch, F, gidx, ng, what):
    """The plan the kernels build for ``gidx`` against ``candidate_plan_plain``:
    the same group for every work item, real slots at the same places, and
    the same slots in each work item once each is sorted (the kernel's order
    within a list is its own). Returns the number of real slots."""
    item_group, slots = F.candidate_plan(gidx, ng)
    item_group_ref, slots_ref = F.candidate_plan_plain(gidx, ng)
    if not torch.equal(item_group, item_group_ref) or not torch.equal(slots >= 0, slots_ref >= 0):
        raise AssertionError(f"{what}: the plan's work items differ from the plain version's")
    # a group's slots may sit in any of its work items: sort by (group, slot)
    group = item_group.long().repeat_interleave(F.PLAN_ROWS)
    key = lambda s: torch.sort(group * gidx.numel() + s.long()).values
    if not torch.equal(key(slots), key(slots_ref)):
        raise AssertionError(f"{what}: the plan's lists differ from the plain version's")
    return int((slots_ref >= 0).sum())


def check_k5_plans(torch, F, u, t, mask, gmax, gidx, case):
    """K5b and K5c on adversarial choices of groups, bit-equal to their plain
    versions on integer operands, their plans equal to the plain plan's, and
    the candidates' maxima equal to K5a's where the groups are real: every
    row choosing the same groups; every slot a pad slot (ids n_groups and
    -1); one group chosen by every row, as the only slot."""
    b, ng = u.shape[0], gmax.shape[1]
    kp = gidx.shape[1]
    choices = {
        "every_row_the_same_groups": gidx[:1].expand(b, kp).contiguous(),
        "all_pad_slots": torch.where(torch.arange(kp, device=u.device) % 2 == 0, ng, -1)
        .to(torch.int32).expand(b, kp).contiguous(),
        "one_group_chosen_by_every_row": torch.full((b, 1), ng // 2, dtype=torch.int32, device=u.device),
    }
    for name, g in choices.items():
        what = f"K5 {case} {name}"
        cand = F.fused_candidates(u, t, g, mask)
        raw = F.fused_candidates_unmasked(u, t, g)
        if not torch.equal(cand, F.fused_candidates_plain(u, t, g, mask)):
            raise AssertionError(f"{what}: K5b differs from the plain version")
        if not torch.equal(raw, F.fused_candidates_unmasked_plain(u, t, g)):
            raise AssertionError(f"{what}: K5c differs from the plain version")
        listed = check_plan(torch, F, g, ng, what)
        real = (g >= 0) & (g < ng)
        refold = cand.view(b, g.shape[1], 128).float().amax(dim=2).bfloat16()
        folded = gmax.gather(1, torch.where(real, g, 0).long())
        if not torch.equal(refold[real], folded[real]) or not bool(torch.isinf(cand.view(b, -1, 128)[~real]).all()):
            raise AssertionError(f"{what}: the candidates' maxima differ from K5a's, or a pad slot is not -inf")
        print(f"{what}: b={b} kp={g.shape[1]} listed slots {listed}: K5b and K5c bit-equal to plain, plan equal, "
              f"candidates' maxima equal K5a's")


def check_k5(torch, shapes, k, card):
    """K5a, K5b, K5c and K3 on bfloat16 rows, each against its plain version
    on the card, on each (name, n_items, d, mask) shape and in two kinds of
    case: integer-valued operands, where everything must be equal bit for
    bit, ties included; and Gaussian operands, where the kernel's float32
    sums run in another order than the plain version's and a score may round
    to the other side of a bfloat16 boundary: values within one ulp, the
    share that differs printed, the index lists held by
    ``check_topk_lists``. The whole fused function is also timed against the
    library's way to the same result (a bfloat16 matmul, masked_fill,
    torch.topk), which writes the score plane; K5a against the library's
    three calls for its own function (the bfloat16 matmul, masked_fill, amax
    over (b, n_groups, 128)) and the matmul alone; the route's choice of
    groups by its sort against K3's. On the elec-width shape K5a also runs
    ``check_k5a_edges``. Returns the per-kernel results; their top-level
    times are the first shape's Gaussian case."""
    from genmmrec_tpu_torch.ops import fused_topk as F
    from genmmrec_tpu_torch.ops.topk import (
        choose_groups, choose_groups_by_sort, grouped_topk, grouped_topk_plain, unpack_mask,
    )

    names = ("fused_group_max", "fused_candidates", "fused_candidates_unmasked", "grouped_topk_bf16")
    res = {name: dict(max_abs_err=0.0, cases=[]) for name in names}
    fused_cases = []
    for shape_name, n, d, mask in shapes:
        b, dev = mask.shape[0], mask.device
        ng = F.n_groups_for(n)
        kp = min(k, ng)
        excluded = unpack_mask(mask, n)
        for exact in (True, False):
            kind = "integer" if exact else "gaussian"
            case = f"{shape_name}_{kind}"
            u32, t32 = k5_operands(torch, b, n, d, exact, SEED + (0 if exact else 1), dev)
            u, t = u32.bfloat16(), t32.bfloat16()

            def compare(what, out, ref, magnitude=None):
                """(largest finite difference, share of entries that differ).
                Where ``magnitude`` (Σ|u·t| of each entry) is given, an entry
                may also differ by K1_RTOL of it: two float32 sums of terms
                that cancel differ by a share of the terms' size, which near
                a zero score is many ulps of the score."""
                if exact:
                    if not torch.equal(out, ref):
                        raise AssertionError(f"{what} {case}: kernel and plain version differ on integer operands")
                    return 0.0, 0.0
                apart = (bf16_ordinal(torch, out) - bf16_ordinal(torch, ref)).abs()
                diff = (out.float() - ref.float()).abs().nan_to_num(nan=0.0)  # -inf against -inf
                ok = apart <= 1
                if magnitude is not None:
                    ok |= diff <= K1_RTOL * magnitude.float()
                if not bool(ok.all()):
                    raise AssertionError(f"{what} {case}: kernel and plain version differ by more than one ulp")
                return diff[torch.isfinite(diff)].max().item(), float((apart != 0).float().mean())

            # K5a
            gmax = F.fused_group_max(u, t, mask)
            err_a, share_a = compare("K5a", gmax, F.fused_group_max_plain(u, t, mask))
            # the groups as fused_grouped_topk hands them on; a second set
            # ends in a pad slot and holds an id below 0
            ranked = torch.sort(gmax, dim=1, descending=True, stable=True).indices[:, :kp]
            gidx = torch.sort(ranked, dim=1).values.to(torch.int32)
            gidx_pad = torch.cat([gidx[:256, : kp - 1], torch.full_like(gidx[:256, :1], ng)], dim=1).contiguous()
            gidx_pad[::2, 0] = -1
            # K5b, K5c
            cand = F.fused_candidates(u, t, gidx, mask)
            raw = F.fused_candidates_unmasked(u, t, gidx)
            magnitude = F.fused_candidates_unmasked_plain(u.abs(), t.abs(), gidx)
            err_b, share_b = compare("K5b", cand, F.fused_candidates_plain(u, t, gidx, mask), magnitude)
            err_c, share_c = compare("K5c", raw, F.fused_candidates_unmasked_plain(u, t, gidx), magnitude)
            del magnitude
            magnitude = F.fused_candidates_unmasked_plain(u[:256].abs(), t.abs(), gidx_pad).clamp(min=0)
            compare("K5b pad slots", F.fused_candidates(u[:256], t, gidx_pad, mask[:256]),
                    F.fused_candidates_plain(u[:256], t, gidx_pad, mask[:256]), magnitude)
            compare("K5c pad slots", F.fused_candidates_unmasked(u[:256], t, gidx_pad),
                    F.fused_candidates_unmasked_plain(u[:256], t, gidx_pad), magnitude)
            if not torch.equal(F.external_mask(raw, gidx, mask), cand):
                raise AssertionError(f"K5 {case}: K5c + external_mask differs from K5b")
            # a candidate is the score K5a folded: same instruction, same order
            refold = cand.view(b, kp, 128).float().amax(dim=2).bfloat16()
            if not torch.equal(refold, gmax.gather(1, gidx.long())):
                raise AssertionError(f"K5 {case}: the candidates' maxima differ from the maxima K5a folded")
            check_plan(torch, F, gidx, ng, f"K5 {case}")
            if exact:
                check_k5_plans(torch, F, u, t, mask, gmax, gidx, case)
            # K3 on the bfloat16 candidate plane
            v3, i3 = grouped_topk(cand, k)
            v3_ref, i3_ref = grouped_topk_plain(cand, k)
            if not (torch.equal(i3, i3_ref) and torch.equal(v3, v3_ref)):
                raise AssertionError(f"K3 bf16 {case}: kernel and plain version differ")
            # the whole function, both ways to mask, against the plane's top-k
            plane = F.score_plane(u, t).masked_fill(excluded, float("-inf"))
            v_ref, i_ref = grouped_topk_plain(plane, k)
            v, i = F.fused_grouped_topk(u32, t32, k, mask)
            v_e, i_e = F.fused_grouped_topk(u32, t32, k, mask, cand_mask="external")
            torch.cuda.synchronize()
            if not (torch.equal(v, v_e) and torch.equal(i, i_e)):
                raise AssertionError(f"K5 {case}: cand_mask 'kernel' and 'external' differ")
            err_f, share_f = compare("fused top-k values", v, v_ref)
            if exact:
                if not torch.equal(i, i_ref):
                    raise AssertionError(f"K5 {case}: fused indices differ from the plane's top-k on integer operands")
                idx_share = 0.0
            else:
                idx_share = check_topk_lists(torch, f"K5 {case}", plane, i, i_ref, n)
            # a k past the threshold path's 64, fused against the plane route (K3 on the plane)
            v_w, i_w = F.fused_grouped_topk(u32, t32, WIDE_K, mask)
            v_wr, i_wr = grouped_topk(plane, WIDE_K)
            torch.cuda.synchronize()
            if exact and not (torch.equal(v_w, v_wr) and torch.equal(i_w, i_wr)):
                raise AssertionError(f"K5 {case}: fused top-{WIDE_K} differs from the plane route's")
            if not exact:
                compare(f"fused top-{WIDE_K} values", v_w, v_wr)
                check_topk_lists(torch, f"K5 {case} top-{WIDE_K}", plane, i_w, i_wr, n)
            print(f"K5 {case} fused_grouped_topk at k={WIDE_K}: "
                  f"{'bit-equal to' if exact else 'within one ulp of'} the plane route (K3 on the masked plane)")
            del plane

            # times: kernel and plain in turns, then the library's way
            a_ms, a_plain = timed_pair(torch, lambda: F.fused_group_max(u, t, mask),
                                       lambda: F.fused_group_max_plain(u, t, mask))
            # at baby the kernel takes less than the host's time per call:
            # its device time alone, from a CUDA graph
            a_graph = graph_ms(torch, lambda: F.fused_group_max(u, t, mask))
            # K5a's yardsticks, three calls and the first alone: the bf16
            # matmul against the table padded to whole groups, masked_fill,
            # amax over the (b, n_groups, 128) view
            t_pad = torch.nn.functional.pad(t, (0, 0, 0, ng * 128 - n))
            excluded_pad = unpack_mask(mask, ng * 128)
            a_lib = cuda_ms(torch, lambda: (u @ t_pad.T).masked_fill(excluded_pad, float("-inf"))
                            .view(b, ng, 128).amax(dim=2))
            a_matmul = cuda_ms(torch, lambda: u @ t_pad.T)
            del t_pad, excluded_pad
            # the fused route's choice of groups: its sort, and K3's top-kp of
            # the maxima as the two-stage route chooses, in turns
            if not torch.equal(choose_groups(gmax, kp), choose_groups_by_sort(gmax, kp)):
                raise AssertionError(f"K5 {case}: K3's choice of groups differs from the sort's")
            choose_k3, choose_sort = timed_pair(torch, lambda: choose_groups(gmax, kp),
                                                lambda: choose_groups_by_sort(gmax, kp))
            b_ms, b_plain = timed_pair(torch, lambda: F.fused_candidates(u, t, gidx, mask),
                                       lambda: F.fused_candidates_plain(u, t, gidx, mask))
            c_ms, c_plain = timed_pair(torch, lambda: F.fused_candidates_unmasked(u, t, gidx),
                                       lambda: F.fused_candidates_unmasked_plain(u, t, gidx))
            plan_ms = cuda_ms(torch, lambda: F.candidate_plan(gidx, ng))  # inside b_ms and c_ms
            k3_ms, k3_plain = timed_pair(torch, lambda: grouped_topk(cand, k), lambda: grouped_topk_plain(cand, k))
            k3_lib = cuda_ms(torch, lambda: torch.topk(cand, k, dim=1))
            library = lambda: torch.topk((u @ t.T).masked_fill(excluded, float("-inf")), k, dim=1)
            f_ms, lib_ms = timed_pair(torch, lambda: F.fused_grouped_topk(u, t, k, mask), library)
            fe_ms = cuda_ms(torch, lambda: F.fused_grouped_topk(u, t, k, mask, cand_mask="external"))
            f_plain = cuda_ms(torch, lambda: grouped_topk_plain(
                F.score_plane(u, t).masked_fill(excluded, float("-inf")), k))

            table_rows = nbytes(t)  # each table row read once, whatever the rows' choices
            bounds = {
                "fused_group_max": Bound().add(nbytes(u, t, mask, gmax), 2.0 * b * n * d, BF16_FLOPS),
                "fused_candidates": Bound().add(
                    nbytes(u, gidx, cand) + table_rows + b * kp * 16, 2.0 * b * kp * 128 * d, BF16_FLOPS),
                "fused_candidates_unmasked": Bound().add(
                    nbytes(u, gidx, raw) + table_rows, 2.0 * b * kp * 128 * d, BF16_FLOPS),
                "grouped_topk_bf16": Bound().add(nbytes(cand, v3, i3), float(cand.numel()), F32_FLOPS),
            }
            fused_bound = Bound().add(nbytes(u, t, mask, v, i), 2.0 * b * n * d, BF16_FLOPS)
            # no one PyTorch call computes a K5 stage alone: their library_ms
            # is the library's way to the whole function, to hold against fused_ms
            rows = {
                "fused_group_max": (err_a, share_a, a_ms, a_plain, a_lib),
                "fused_candidates": (err_b, share_b, b_ms, b_plain, lib_ms),
                "fused_candidates_unmasked": (err_c, share_c, c_ms, c_plain, lib_ms),
                "grouped_topk_bf16": (0.0, 0.0, k3_ms, k3_plain, k3_lib),
            }
            for name, (e, share, ms, plain_ms, l_ms) in rows.items():
                entry = dict(case=case, b=b, n_items=n, d=d, k=k, kp=kp, max_abs_err=e, differing_share=share,
                             ms=ms, plain_ms=plain_ms, library_ms=l_ms, **bounds[name])
                if name == "fused_group_max":
                    entry.update(
                        graph_ms=a_graph, matmul_ms=a_matmul, fused_ms=f_ms, fused_library_ms=lib_ms,
                        library_of="three calls: bfloat16 matmul, masked_fill, amax over (b, n_groups, 128)",
                    )
                elif name.startswith("fused_"):
                    entry.update(
                        fused_ms=fe_ms if name == "fused_candidates_unmasked" else f_ms,
                        library_of="fused_grouped_topk whole: bfloat16 matmul + masked_fill + torch.topk",
                    )
                if name.startswith("fused_candidates"):
                    entry["plan_ms"] = plan_ms
                res[name]["cases"].append(entry)
                res[name]["max_abs_err"] = max(res[name]["max_abs_err"], e)
                note = "bit-equal" if exact else f"{share:.2e} of entries differ, none beyond its bound"
                plan = f" (its plan {plan_ms:.4f} ms)" if "plan_ms" in entry else ""
                if name == "fused_group_max":
                    plan = (f" (from a CUDA graph {a_graph:.4f} ms; library: matmul + masked_fill + amax {a_lib:.4f} ms, "
                            f"the matmul alone {a_matmul:.4f} ms)")
                print(
                    f"K5 {case} {name}: b={b} n={n} d={d} kp={kp} max_abs_err={e:.3e} ({note}), "
                    f"kernel {ms:.4f} ms{plan}, plain {plain_ms:.4f} ms, bound {bounds[name]['bound_ms']:.4f} ms "
                    f"({bounds[name]['bound_by']}) [{card}]"
                )
            fused_cases.append(dict(
                case=case, b=b, n_items=n, d=d, k=k, max_abs_err=err_f, differing_value_share=share_f,
                differing_index_share=idx_share, ms=f_ms, external_ms=fe_ms, plain_ms=f_plain,
                library_ms=lib_ms, choose_groups_by_sort_ms=choose_sort, choose_groups_by_k3_ms=choose_k3,
                **fused_bound,
            ))
            note = "and indices bit-equal" if exact else (
                f"within one ulp ({share_f:.2e} differ), {idx_share:.2e} of indices differ, all near-ties")
            print(
                f"K5 {case} fused_grouped_topk: values {note}; 'kernel' and 'external' bit-equal; "
                f"fused {f_ms:.4f} ms (external {fe_ms:.4f} ms), plain plane "
                f"route {f_plain:.4f} ms, library (bf16 matmul + masked_fill + torch.topk) {lib_ms:.4f} ms, "
                f"bound {fused_bound['bound_ms']:.4f} ms ({fused_bound['bound_by']}); its choice of {kp} groups "
                f"by the sort {choose_sort:.4f} ms, by K3 {choose_k3:.4f} ms (the same ids) [{card}]"
            )
            del u32, t32, u, t, cand, raw
        # peak memory of one fused call at this shape, beside the plane it avoids
        u32, t32 = k5_operands(torch, b, n, d, False, SEED + 1, dev)
        u, t = u32.bfloat16(), t32.bfloat16()
        del u32, t32
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        F.fused_grouped_topk(u, t, k, mask)
        torch.cuda.synchronize()
        rise = torch.cuda.max_memory_allocated() - before
        plane_bytes = b * n * 2
        print(
            f"K5 {shape_name}: peak memory rise of one fused_grouped_topk call {rise / 1e6:.1f} MB; "
            f"the bfloat16 score plane it does not write is {plane_bytes / 1e6:.1f} MB"
        )
        fused_cases.append(dict(case=f"{shape_name}_memory", peak_rise_bytes=rise, plane_bytes=plane_bytes))
        if n >= ELEC_ITEMS and rise >= plane_bytes:
            raise AssertionError(f"K5 {shape_name}: the fused route allocated {rise} bytes, a score plane's worth")
        del u, t
    for shape_name, n, d, mask in shapes:
        if n >= ELEC_ITEMS:
            check_k5a_edges(torch, F, n, d, mask)
    check_k5_widths(torch, k, shapes[0][3].device)
    for name in names:
        first = next(c for c in res[name]["cases"] if c["case"].endswith("gaussian"))
        keys = ("ms", "graph_ms", "plan_ms", "plain_ms", "library_ms", "matmul_ms", "bound_ms", "bound_by", "fused_ms",
                "fused_library_ms", "library_of")
        res[name].update({key: first[key] for key in keys if key in first})
    res["fused_grouped_topk"] = fused_cases
    return res


def k5a_against(torch, dirs, card):
    """K5a of this checkout against the K5a of each other checkout in
    ``dirs`` (an earlier commit unpacked by ``git archive``, or a build not
    kept), each built from its own sources into its own ``build/kernels``:
    the same inputs at the baby and elec shapes, Gaussian operands, each
    held within one ulp of the plain version, times in turns (other, this,
    this, other) of 50 launches each, as launched (``cuda_ms``) and replayed
    from a CUDA graph (``graph_ms``: the device's time alone)."""
    import ctypes
    import importlib.util

    from genmmrec_tpu_torch.ops import fused_topk as F

    dev = torch.device("cuda:0")
    others = {}
    for d in dirs:
        spec = importlib.util.spec_from_file_location(
            f"k5a_build_{len(others)}", os.path.join(d, "genmmrec_tpu_torch", "ops", "_build.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        lib = ctypes.CDLL(mod.build()[0])
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_group_max_bf16.argtypes = [p, p, p, p, i, i, i, p]
        lib.fused_group_max_bf16.restype = i
        others[os.path.basename(os.path.normpath(d))] = lib

    def other(lib, u, t, mask):
        u, t, b, n, d = F._check_operands(u, t, mask)
        out = torch.empty(b, F.n_groups_for(n), dtype=torch.bfloat16, device=dev)
        rc = lib.fused_group_max_bf16(u.data_ptr(), t.data_ptr(), mask.data_ptr(), out.data_ptr(), b, n, d,
                                      torch._C._cuda_getCurrentRawStream(0))
        if rc:
            raise RuntimeError(f"another checkout's K5a failed: CUDA error {rc}")
        return out

    res = []
    for shape, n, per_row in (("baby", 7050, 20), ("elec", ELEC_ITEMS, ELEC_POSITIVES)):
        mask = elec_mask(torch, 4096, n, per_row, SEED + 5, dev)
        u, t = (x.bfloat16() for x in k5_operands(torch, 4096, n, 64, False, SEED + 1, dev))
        ref = F.fused_group_max_plain(u, t, mask)
        for name, lib in others.items():
            for what, out in (("this", F.fused_group_max(u, t, mask)), (name, other(lib, u, t, mask))):
                if not bool(((bf16_ordinal(torch, out) - bf16_ordinal(torch, ref)).abs() <= 1).all()):
                    raise AssertionError(f"K5a of {what} at {shape}: more than one ulp from the plain version")
            mine, theirs = lambda: F.fused_group_max(u, t, mask), lambda: other(lib, u, t, mask)
            times = {}
            for how, timer in (("launched", lambda f: cuda_ms(torch, f, iters=50)), ("graph", lambda f: graph_ms(torch, f))):
                o1, k1, k2, o2 = timer(theirs), timer(mine), timer(mine), timer(theirs)
                times[how] = dict(ms=[k1, k2], other_ms=[o1, o2])
                print(f"K5a {shape} (4096, {n}) d=64, {how}: this checkout {k1:.4f}, {k2:.4f} ms; {name} {o1:.4f}, "
                      f"{o2:.4f} ms [{card}]")
            res.append(dict(shape=shape, other=name, **times))
    return res


def counted_wrappers():
    """name -> the wrapper whose ``launches`` counts that kernel's launches."""
    from genmmrec_tpu_torch.ops.fused_topk import fused_candidates, fused_candidates_unmasked, fused_group_max
    from genmmrec_tpu_torch.ops import segment as S
    from genmmrec_tpu_torch.ops.topk import candidate_extract, grouped_topk, masked_group_max

    return {
        "segment_spmm": S.segment_spmm,
        "segment_spmm_backward": S.segment_spmm_backward,
        "segment_spmm_blocked": S.segment_spmm_blocked,
        "segment_spmm_blocked_backward": S.segment_spmm_blocked_backward,
        "grouped_topk": grouped_topk,
        "candidate_extract": candidate_extract,
        "masked_group_max": masked_group_max,
        "fused_group_max": fused_group_max,
        "fused_candidates": fused_candidates,
        "fused_candidates_unmasked": fused_candidates_unmasked,
    }


def launch_counts():
    return {name: fn.launches for name, fn in counted_wrappers().items()}


def reset_counts():
    for fn in counted_wrappers().values():
        fn.launches = 0


def train_epoch(torch, trainer, epoch: int, card, profile_dir=None, unread=()):
    """One epoch as ``Trainer.fit`` runs it (the prelude's phases 1 and 2,
    then the BPR + InfoNCE epoch), timed phase by phase; each phase checked
    for the parameters it must leave alone (phases 1 and 2 every ``rec``
    parameter, the BPR epoch the denoisers and the ``rec`` parameters named
    in ``unread``, which its loss does not read) and for its launches."""
    model = trainer.model
    groups = model.param_groups()
    named = dict(model.named_parameters())
    snap = lambda names: [p.detach().clone() for n in names for p in groups[n]]
    same = lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b))
    dn = tuple(k for k in groups if k != "rec")
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
            name = f"{type(model).__name__}_epoch{epoch}_{label}"
            write_profile(torch, prof, profile_dir, name, res[f"{label}_s"], card)
        res[f"{label}_launches"] = launch_counts()
        return out

    res["epoch"] = epoch
    rec0 = snap(["rec"])
    gen = trainer.split("epoch", epoch, "prelude")
    if profiler is None:
        # the prelude's own timers split phase 1 from phase 2
        run("prelude", lambda: trainer._epoch_prelude(gen, epoch))
        log = trainer.prelude_log
    else:
        # the prelude's two phases, each under its own profiler
        losses = run("diffusion", lambda: trainer._diffusion_epoch(gen).cpu())
        run("regenerate", lambda: trainer.regenerate(gen))
        log = dict(diffusion_s=res["diffusion_s"], regenerate_s=res["regenerate_s"], **trainer._loss_log(losses))
        res["prelude_launches"] = {
            k: res["diffusion_launches"][k] + res["regenerate_launches"][k] for k in res["diffusion_launches"]
        }
        res["prelude_s"] = log["diffusion_s"] + log["regenerate_s"]
    loss_keys = [k for k in log if k.startswith("diffusion_loss")]
    for k in ("diffusion_s", "regenerate_s", *loss_keys):
        res[k] = log[k]
    if not same(rec0, snap(["rec"])):
        raise AssertionError(f"epoch {epoch}: phases 1 and 2 changed rec parameters")
    dn0 = snap(dn)
    unread0 = [named[n].detach().clone() for n in unread]
    losses = run("bpr", lambda: trainer._train_epoch(trainer.split("epoch", epoch, "train")).cpu())
    if not same(dn0, snap(dn)):
        raise AssertionError(f"epoch {epoch}: the BPR epoch changed the denoisers")
    if not same(unread0, [named[n] for n in unread]):
        raise AssertionError(f"epoch {epoch}: the BPR epoch changed parameters its loss does not read: {unread}")
    res["bpr_loss_sum"] = float(losses.sum())
    res["bpr_loss_first"], res["bpr_loss_last"] = float(losses[0, 0]), float(losses[-1, 0])
    res["bpr_batches"] = losses.shape[0]
    finite = [res[k] for k in (*loss_keys, "bpr_loss_sum")]
    if not all(math.isfinite(v) for v in finite) or not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"epoch {epoch}: a loss is not finite: {finite}")
    bpr = res["bpr_launches"]
    if bpr["segment_spmm"] <= 0 or bpr["segment_spmm_backward"] <= 0:
        raise AssertionError(f"epoch {epoch}: K1 forward or backward not launched in the BPR epoch: {bpr}")
    if res["prelude_launches"]["grouped_topk"] <= 0:
        raise AssertionError(f"epoch {epoch}: K3 not launched in the regeneration")
    res["epoch_s"] = res["prelude_s"] + res["bpr_s"]
    res["phase1_users_per_s"] = model.n_users / res["diffusion_s"]
    shown = " ".join(f"{k[len('diffusion_loss_'):]} {res[k]:.4f}".strip() for k in loss_keys)
    print(
        f"{type(model).__name__} epoch {epoch}: phase 1 (denoisers) {res['diffusion_s']:.3f} s "
        f"({res['phase1_users_per_s']:.0f} users/s), loss {shown}; phase 2 (regenerate) {res['regenerate_s']:.3f} s; "
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


def check_batch_against_cpu(
    torch, trainer, td, train_ds, config, card, loss_kwargs=None, zero_grads=None, card_graphs=(), replay_branches=False
):
    """One training batch on the card and on the CPU, from the same
    parameters, state and batch: the loss and every ``rec`` gradient.

    ``loss_kwargs`` (tensors on the card, such as dropout masks) go to
    ``loss`` on both, copied to the CPU for the CPU's. ``zero_grads`` maps
    a parameter whose gradient is zero but for rounding (a linear bias in
    front of a batch norm, which subtracts the mean) to the weight of its
    layer: on both devices it must stay below GRAD_ATOL of that weight's
    largest gradient.

    Every graph of the model that the CPU builds must equal the card's,
    edge for edge and value for value, but for those named in
    ``card_graphs`` (KNN graphs: a top-k over each device's own similarity
    product may choose another of two near-equal neighbours; K3 against its
    plain version on the card's rows holds the card's choice). Those must
    share CARD_GRAPH_SHARE of their edges, and the CPU takes the card's.

    With ``replay_branches`` the CPU takes each ``leaky_relu`` entry's slope
    as the card took it, where the two devices' pre-activations lie on two
    sides of 0: an entry within rounding of 0 may take the other slope on
    one device, whose gradient differs by 0.8 of its cotangent (not a
    rounding difference). Such an entry must lie within FLIP_RTOL of its
    tensor's largest magnitude on both devices, and such entries may be at
    most FLIP_SHARE of all."""
    from genmmrec_tpu_torch.data.arrays import build_train_data, sample_negatives
    from genmmrec_tpu_torch.ops.graph import SparseGraph

    model, dev, cpu = trainer.model, td.device, torch.device("cpu")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    B = trainer.train_batch_size
    idx = torch.randperm(td.n_inter, generator=gen, device=dev)[:B]
    users, pos = td.users[idx], td.items[idx]
    neg = sample_negatives(users, td.hist, td.item_pool, td.n_pool, trainer.neg_rounds, gen)
    weight = torch.ones(B, device=dev)
    weight[-B // 8 :] = 0.0  # a padded tail, as the epoch's last batch has
    batch = {"users": users, "pos": pos, "neg": neg, "weight": weight}
    cpu_model = type(model)(config, build_train_data(train_ds, cpu))
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu_state = {k: g.to(cpu) for k, g in trainer.state.items()}
    edges_equal = {}
    for name, g in vars(model).items():
        if not isinstance(g, SparseGraph):
            continue
        own = getattr(cpu_model, name)
        same_rows = own.nnz == g.nnz and bool(torch.equal(own.rows, g.rows.cpu()))
        edges_equal[name] = float((own.cols == g.cols.cpu()).float().mean()) if same_rows else 0.0
        if name in card_graphs:
            if edges_equal[name] < CARD_GRAPH_SHARE:
                raise AssertionError(f"{name}: the CPU's graph shares {edges_equal[name]} of the card's edges")
            setattr(cpu_model, name, g.to(cpu))
        elif edges_equal[name] != 1.0 or not torch.equal(own.vals, g.vals.cpu()):
            raise AssertionError(f"{name}: the CPU's graph differs from the card's (edges equal {edges_equal[name]})")
    rec_names = {id(p) for p in model.param_groups()["rec"]}

    def to_cpu(v):
        if torch.is_tensor(v):
            return v.cpu()
        if isinstance(v, dict):
            return {k: to_cpu(x) for k, x in v.items()}
        return tuple(to_cpu(x) for x in v)

    loss_kwargs = loss_kwargs or {}
    cpu_kwargs = to_cpu(loss_kwargs)

    def loss_and_grads(m, state, b, kwargs):
        m.zero_grad(set_to_none=True)
        with torch.enable_grad():
            total, _ = m.loss(state, b, **kwargs)
            total.backward()
        names = [n for n, p in model.named_parameters() if id(p) in rec_names]
        params = dict(m.named_parameters())
        return total.item(), {n: params[n].grad.detach().cpu() for n in names if params[n].grad is not None}

    F = torch.nn.functional
    leaky_relu, on_card = F.leaky_relu, []
    flips = dict(flipped=0, entries=0, worst_flip=0.0, worst_apart=0.0)

    def recording(x, negative_slope=0.01, inplace=False):
        on_card.append(x.detach())
        return leaky_relu(x, negative_slope)

    def replaying(x, negative_slope=0.01, inplace=False):
        card_x, own = on_card.pop(0).cpu(), x.detach()
        apart = (card_x - own).abs() / own.abs().max().clamp(min=1e-30)
        flipped = (card_x > 0) != (own > 0)
        flips["flipped"] += int(flipped.sum())
        flips["entries"] += x.numel()
        flips["worst_apart"] = max(flips["worst_apart"], float(apart.max()))
        if flipped.any():
            # across 0, |card - own| is the sum of the two magnitudes
            flips["worst_flip"] = max(flips["worst_flip"], float(apart[flipped].max()))
        return torch.where(card_x > 0, x, x * negative_slope)

    t0 = time.perf_counter()
    try:
        if replay_branches:
            F.leaky_relu = recording
        loss_gpu, g_gpu = loss_and_grads(model, trainer.state, batch, loss_kwargs)
        if replay_branches:
            F.leaky_relu = replaying
        loss_cpu, g_cpu = loss_and_grads(cpu_model, cpu_state, {k: v.cpu() for k, v in batch.items()}, cpu_kwargs)
    finally:
        F.leaky_relu = leaky_relu
    model.zero_grad(set_to_none=True)
    rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    if g_gpu.keys() != g_cpu.keys():
        raise AssertionError(f"rec gradients of other parameters on the two devices: {g_gpu.keys() ^ g_cpu.keys()}")
    worst = {}
    zero_grads = zero_grads or {}
    for n, ref in g_cpu.items():
        if n in zero_grads:
            scale = GRAD_ATOL * g_cpu[zero_grads[n]].abs().max()
            worst[n] = float(max(ref.abs().max(), g_gpu[n].abs().max()) / scale)
            continue
        diff = (g_gpu[n] - ref).abs()
        bound = GRAD_RTOL * ref.abs() + GRAD_ATOL * ref.abs().max()
        worst[n] = float((diff / bound.clamp(min=1e-30)).max())
    replayed = (
        f"; leaky_relu: {flips['flipped']} of {flips['entries']} entries on other sides of 0 on the two devices, "
        f"the CPU took the card's slope there (the largest such pair {flips['worst_flip']:.2e} of its tensor's "
        f"largest magnitude, bound {FLIP_RTOL:.0e}; any entry's largest difference {flips['worst_apart']:.2e})"
        if replay_branches else ""
    )
    print(
        f"card vs CPU, {type(model).__name__}, one batch of {B}: loss {loss_gpu:.7f} vs {loss_cpu:.7f} (rel {rel:.2e}, "
        f"bound {LOSS_RTOL:.0e}); rec gradients, largest share of the bound per tensor "
        f"{json.dumps({k: round(v, 4) for k, v in worst.items()})} in {time.perf_counter() - t0:.1f} s; the "
        f"model's graphs built on the CPU, share of edges equal to the card's {json.dumps(edges_equal)} "
        f"(the CPU took the card's {list(card_graphs)}){replayed} [{card}]"
    )
    if not math.isfinite(loss_gpu) or rel > LOSS_RTOL:
        raise AssertionError(f"batch loss on the card {loss_gpu} differs from the CPU's {loss_cpu}")
    bad = [n for n, v in worst.items() if not v <= 1.0]
    if bad:
        raise AssertionError(f"rec gradients on the card differ from the CPU's: {bad}")
    if flips["worst_flip"] > FLIP_RTOL or flips["flipped"] > FLIP_SHARE * max(flips["entries"], 1):
        raise AssertionError(f"leaky_relu entries on other sides of 0 past rounding on the two devices: {flips}")
    return dict(loss_rel_err=rel, grad_bound_share=max(worst.values()), cpu_graph_edges_equal=edges_equal, **flips)


def bf16_evaluation_path(torch, config, td, vd, ted, model, valid_f32, test_f32, card, profile_dir=None):
    """The bf16 evaluation through the trainer's entry points, on the
    float32 model's parameters: regenerate, evaluate(valid), evaluate(test)
    by the fused route; evaluate(valid) with the candidates masked outside
    the kernel; evaluate(valid) by the scatter route. Checks the launches of
    each, the three routes' top-50 against each other, that no train
    positive is listed, and the metrics against the float32 evaluation's.
    ``profile_dir`` adds one evaluate(valid) by the fused route under
    ``torch.profiler``."""
    from genmmrec_tpu_torch.config import Config
    from genmmrec_tpu_torch.engine.diffusion_trainers import DiffMMTrainer
    from genmmrec_tpu_torch.models.diffmm import DiffMM
    from genmmrec_tpu_torch.ops.topk import unpack_mask

    cfg = Config("DiffMM", "baby", {"save_recommended_topk": False, "eval_dtype": "bfloat16"})
    cfg["pop_mask"], cfg["warm_mask"] = config["pop_mask"], config["warm_mask"]
    bf_model = DiffMM(cfg, td)
    bf_model.load_state_dict(model.state_dict())
    bf_model.eval()
    tr = DiffMMTrainer(cfg, bf_model)
    for ed in (vd, ted):  # the packed masks are set-up, built once per eval set
        tr._dense_mask(ed)
    res, launches = {}, {}

    def run(label, fn):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        res[f"{label}_s"] = time.perf_counter() - t0
        launches[label] = launch_counts()
        return out

    run("regenerate", tr.regenerate)
    valid = run("eval_valid", lambda: tr.evaluate(vd))
    test = run("eval_test", lambda: tr.evaluate(ted, is_test=True))
    top_kernel = run("topk_valid_kernel", lambda: tr.eval_topk(vd))
    tr._FUSED_CAND_MASK = "external"
    valid_external = run("eval_valid_external", lambda: tr.evaluate(vd))
    top_external = run("topk_valid_external", lambda: tr.eval_topk(vd))
    del tr._FUSED_CAND_MASK
    tr._DENSE_MASK_BUDGET = 0
    valid_scatter = run("eval_valid_scatter", lambda: tr.evaluate(vd))
    top_scatter = run("topk_valid_scatter", lambda: tr.eval_topk(vd))
    del tr._DENSE_MASK_BUDGET
    top_test = tr.eval_topk(ted)

    def need(label, *names):
        missing = [n for n in names if launches[label][n] <= 0]
        if missing:
            raise AssertionError(f"bf16 {label}: {missing} not launched: {launches[label]}")

    for label in ("eval_valid", "eval_test"):
        need(label, "segment_spmm", "fused_group_max", "fused_candidates", "grouped_topk")
    need("eval_valid_external", "fused_group_max", "fused_candidates_unmasked", "grouped_topk")
    need("eval_valid_scatter", "grouped_topk")
    for label, names in (
        ("eval_valid", ("fused_candidates_unmasked",)),
        ("eval_valid_external", ("fused_candidates",)),
        ("eval_valid_scatter", ("fused_group_max", "fused_candidates", "fused_candidates_unmasked")),
    ):
        stray = [n for n in names if launches[label][n] > 0]
        if stray:
            raise AssertionError(f"bf16 {label}: {stray} launched on a route that does not use them")

    # the three routes' lists
    if not torch.equal(top_kernel, top_external):
        raise AssertionError("bf16 evaluation: cand_mask 'kernel' and 'external' give different top-50 lists")
    mask = tr._dense_mask(vd)
    arts = bf_model.eval_artifacts(tr.state)
    plane = bf_model.scores_cached(tr.state, vd.users, arts).masked_fill(unpack_mask(mask, td.n_items), float("-inf"))
    differing = check_topk_lists(
        torch, "bf16 evaluation, fused against scatter route", plane, top_kernel, top_scatter, td.n_items, rows=vd.valid
    )
    del plane
    for name, ed, top in (("valid", vd, top_kernel), ("test", ted, top_test)):
        m = tr._dense_mask(ed)
        listed = (m.gather(1, top >> 3) >> (top & 7).to(torch.uint8)) & 1
        if top.min().item() < 0 or listed[ed.valid].any():
            raise AssertionError(f"bf16 evaluation ({name}): a pad entry or a train positive is in the top-50")

    results = {"valid": valid, "test": test, "valid external": valid_external, "valid scatter": valid_scatter}
    for name, got in results.items():
        bad = [k for k, v in got.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"bf16 {name}: non-finite metrics {bad}")
    if valid_external != valid:
        raise AssertionError("bf16 evaluation: 'kernel' and 'external' metrics differ")
    drift = {}
    pairs = (("valid", valid, valid_f32), ("test", test, test_f32), ("valid_scatter", valid_scatter, valid_f32))
    for name, got, ref in pairs:
        for key in ("recall@20", "ndcg@20"):
            drift[f"{name}_{key}"] = got[key] - ref[key]
    off = {k: v for k, v in drift.items() if abs(v) > BF16_METRIC_ATOL}
    if off:
        raise AssertionError(f"bf16 metrics stray from the float32 evaluation's by more than {BF16_METRIC_ATOL}: {off}")
    print(
        f"bf16 evaluation: regenerate {res['regenerate_s']:.3f} s; evaluate(valid) fused {res['eval_valid_s']:.3f} s, "
        f"evaluate(test) fused {res['eval_test_s']:.3f} s, "
        f"evaluate(valid) external {res['eval_valid_external_s']:.3f} s, "
        f"evaluate(valid) scatter {res['eval_valid_scatter_s']:.3f} s; eval_topk(valid) alone: fused "
        f"{res['topk_valid_kernel_s']:.3f} s, external {res['topk_valid_external_s']:.3f} s, scatter "
        f"{res['topk_valid_scatter_s']:.3f} s [{card}]"
    )
    print(f"bf16 launches: {json.dumps(launches)}")
    print(f"bf16 valid: {json.dumps(valid)}")
    print(f"bf16 test: {json.dumps(test)}")
    print(
        f"bf16 checks: 'kernel' and 'external' top-50 bit-equal; fused and scatter lists differ in {differing:.2e} of "
        f"entries, all within one ulp of the k-th score; no train positive listed; metrics finite; Recall@20 and "
        f"NDCG@20 against float32: {json.dumps({k: round(v, 6) for k, v in drift.items()})} (bound {BF16_METRIC_ATOL})"
    )
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tr.evaluate(vd)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        write_profile(torch, prof, profile_dir, "bf16_eval_valid", wall, card)
    # the evaluate calls are the path; the eval_topk calls beside them only fetch the lists to compare
    path_calls = [l for name, l in launches.items() if not name.startswith("topk_")]
    total = {k: sum(l[k] for l in path_calls) for k in launches["eval_valid"]}
    return dict(**res, valid=valid, test=test, metric_drift=drift, fused_vs_scatter_differing=differing,
                launches_by_call=launches, launches=total)


def synthetic_tables(config, seed: int):
    """(train, valid, test) interaction tables at the sizes of the config's
    dataset tier (``synthetic_n_users``/``_items``/``_inters``), with the
    dataset generator's distributions: log-normal user activity, Zipf-0.8
    item popularity under a random item permutation, and the last two of a
    user's items held out (valid, then test) when it has three or more.
    Drawn in bulk: a user's items come with replacement and repeats are
    dropped, where the dataset generator loops over the users drawing
    without replacement, which takes minutes at 192,403 users."""
    import numpy as np

    from genmmrec_tpu_torch.data.dataset import InterTable

    n_users, n_items, n_inters = (int(config[f"synthetic_n_{k}"]) for k in ("users", "items", "inters"))
    rng = np.random.default_rng(seed)
    act = rng.lognormal(0.0, 1.0, n_users)
    counts = np.maximum(3, (act / act.sum() * n_inters).astype(np.int64))
    counts = np.minimum(counts, min(n_items, 1000))
    pop = 1.0 / np.arange(1, n_items + 1) ** 0.8
    cdf = np.cumsum(pop / pop.sum())
    item_perm = rng.permutation(n_items)
    users = np.repeat(np.arange(n_users), counts)
    items = item_perm[np.minimum(np.searchsorted(cdf, rng.random(len(users))), n_items - 1)]
    first = np.sort(np.unique(users * n_items + items, return_index=True)[1])
    users, items = users[first], items[first]
    counts = np.bincount(users, minlength=n_users)
    from_end = np.cumsum(counts)[users] - 1 - np.arange(len(users))
    labels = np.where(counts[users] >= 3, np.select([from_end == 0, from_end == 1], [2, 1], 0), 0)
    return [
        InterTable(users[labels == lab].astype(np.int32), items[labels == lab].astype(np.int32), n_users, n_items)
        for lab in range(3)
    ]


def graph_cf_setup(torch, dev, model_name="LightGCN", dataset="elec", overrides=None):
    """A graph-CF model at a dataset tier's full width: synthetic tables of
    the tier's sizes, ``get_model``, parameters from the seeded generator,
    the trainer with its batch plan, and the valid split's packed mask.
    ``overrides`` change the config, for a dry run of the control flow at
    small sizes; on a CPU device such a run skips the launch checks."""
    from types import SimpleNamespace

    from genmmrec_tpu_torch.config import Config
    from genmmrec_tpu_torch.data.arrays import build_eval_data, build_train_data
    from genmmrec_tpu_torch.data.dataset import RecDataset
    from genmmrec_tpu_torch.engine.trainer import Trainer
    from genmmrec_tpu_torch.models import get_model

    t0 = time.perf_counter()
    over = {"save_recommended_topk": False, "n_layers": 2, **(overrides or {})}
    config = Config(model_name, dataset, over)
    train_ds, valid_ds, _ = (RecDataset(config, t) for t in synthetic_tables(config, SEED))
    eval_bs = int(config["eval_batch_size"])
    td = build_train_data(train_ds, dev)
    vd = build_eval_data(valid_ds, train_ds, eval_bs, dev)
    model = get_model(model_name)(config, td)
    model.init_params(torch.Generator(device=dev).manual_seed(SEED))
    trainer = Trainer(config, model)
    trainer._build_train_step(td)
    mask = trainer._dense_mask(vd)  # built once per eval set
    g = model.norm_adj
    longest = int((g.row_ptr[1:] - g.row_ptr[:-1]).max())
    empty = int((g.row_ptr[1:] == g.row_ptr[:-1]).sum())
    print(
        f"set-up: {model_name}/{dataset} users={td.n_users} items={td.n_items} train_inters={td.n_inter} "
        f"valid_users={vd.n_users_eval} embedding={model.latent_dim} layers={model.n_layers}; adjacency "
        f"n_rows={g.n_rows} nnz={g.nnz} longest_row={longest} empty_rows={empty} kernel={'K2' if g.blocked else 'K1'}; "
        f"operand at d=64 {g.n_rows * 64 * 4} bytes, packed mask {mask.numel()} bytes, in "
        f"{time.perf_counter() - t0:.1f} s (host)"
    )
    facts = dict(n_users=td.n_users, n_items=td.n_items, n_inter=td.n_inter, adjacency_rows=g.n_rows,
                 adjacency_nnz=g.nnz, longest_row=longest, empty_rows=empty, blocked=g.blocked)
    return SimpleNamespace(name=f"{model_name}/{dataset}", model_name=model_name, dataset=dataset, over=over,
                           config=config, train_ds=train_ds, td=td, vd=vd, model=model, trainer=trainer, mask=mask,
                           eval_bs=eval_bs, facts=facts)


def graph_cf_path(torch, setup, card, steps=40, profile_dir=None):
    """The graph-CF path through the trainer's entry points: ``steps``
    training batches through ``Trainer._train_epoch``, then
    ``evaluate(valid)`` three ways: float32 (K3), float32 with
    ``GENMMREC_PALLAS_TOPK`` set around the call (the two-stage route, K4),
    and ``eval_dtype: bfloat16`` (the fused route, K5). Checks the losses,
    that the steps changed the parameters, the launches of each call, the
    routes' lists and metrics against each other, and one batch against the
    CPU. ``profile_dir`` adds ten more training batches and one more
    evaluation by each of the two-stage and fused routes under
    ``torch.profiler``. Returns (results, launches by call, launches of the
    whole path)."""
    from genmmrec_tpu_torch.config import Config
    from genmmrec_tpu_torch.engine.trainer import Trainer
    from genmmrec_tpu_torch.models import get_model

    name, config, td, vd, model, trainer, mask = (
        setup.name, setup.config, setup.td, setup.vd, setup.model, setup.trainer, setup.mask)
    dev, eval_bs, g = td.device, setup.eval_bs, model.norm_adj
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    res, launches = dict(setup.facts), {}

    def run(label, fn):
        reset_counts()
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        res[f"{label}_s"] = time.perf_counter() - t0
        launches[label] = launch_counts()
        return out

    # -- training: the first rows of one epoch's permutation ---------------
    gen = trainer.split("epoch", 0, "train")
    B = trainer.train_batch_size
    perm = torch.randperm(trainer._num_batches * B, generator=gen, device=dev).reshape(-1, B)
    before = [p.detach().clone() for p in model.parameters()]
    run("warmup_step", lambda: trainer._train_epoch(gen, plan={"idx": perm[:1]}))
    losses = run("train", lambda: trainer._train_epoch(gen, plan={"idx": perm[1 : 1 + steps]}).cpu())
    if losses.shape != (steps, 1) or not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"{name}: training losses {tuple(losses.shape)} are not all finite")
    if any(torch.equal(a, p.detach()) for a, p in zip(before, model.parameters())):
        raise AssertionError(f"{name}: a parameter did not change in {steps} steps")
    fwd, bwd = ("segment_spmm_blocked", "segment_spmm_blocked_backward") if g.blocked else ("segment_spmm", "segment_spmm_backward")
    other = ("segment_spmm", "segment_spmm_backward") if g.blocked else ("segment_spmm_blocked", "segment_spmm_blocked_backward")
    tl = launches["train"]
    if dev.type == "cuda" and (tl[fwd] <= 0 or tl[bwd] <= 0 or tl[other[0]] or tl[other[1]]):
        raise AssertionError(f"{name}: training launched {tl}; expected only {fwd} and {bwd}")
    res["step_ms"] = res["train_s"] / steps * 1e3
    print(
        f"{name} training: {steps} batches of {B} in {res['train_s']:.3f} s ({res['step_ms']:.2f} ms a "
        f"step; a first step {res['warmup_step_s']:.3f} s), loss first {float(losses[0, 0]):.5f} last "
        f"{float(losses[-1, 0]):.5f}; launches {tl} [{card}]"
    )

    # -- evaluation, three routes -------------------------------------------
    valid_k3 = run("eval_valid_f32_k3", lambda: trainer.evaluate(vd))
    top_k3 = trainer.eval_topk(vd)
    os.environ["GENMMREC_PALLAS_TOPK"] = "1"
    try:
        valid_k4 = run("eval_valid_f32_k4", lambda: trainer.evaluate(vd))
        top_k4 = trainer.eval_topk(vd)
    finally:
        del os.environ["GENMMREC_PALLAS_TOPK"]
    bf_config = Config(setup.model_name, setup.dataset, {**setup.over, "eval_dtype": "bfloat16"})
    bf_model = get_model(setup.model_name)(bf_config, td)
    bf_model.load_state_dict(model.state_dict())
    bf_trainer = Trainer(bf_config, bf_model)
    bf_trainer._mask_cache = trainer._mask_cache  # the same eval set's mask, built above
    valid_bf = run("eval_valid_bf16_k5", lambda: bf_trainer.evaluate(vd))
    top_bf = bf_trainer.eval_topk(vd)

    if dev.type == "cuda":
        need = {
            "eval_valid_f32_k3": ([fwd, "grouped_topk"], ["candidate_extract", "masked_group_max", "fused_group_max"]),
            # K3 chooses the groups on the two-stage route
            "eval_valid_f32_k4": ([fwd, "masked_group_max", "grouped_topk", "candidate_extract"], ["fused_group_max"]),
            "eval_valid_bf16_k5": (
                [fwd, "fused_group_max", "fused_candidates", "grouped_topk"], ["candidate_extract", "masked_group_max"]
            ),
        }
        for label, (wanted, unwanted) in need.items():
            missing = [n for n in wanted if launches[label][n] <= 0]
            stray = [n for n in unwanted if launches[label][n] > 0]
            if missing or stray:
                raise AssertionError(f"{name} {label}: not launched {missing}, stray {stray}: {launches[label]}")
    if not torch.equal(top_k3, top_k4):
        bad = (top_k3 != top_k4).any(dim=1).sum().item()
        raise AssertionError(f"{name}: the K3 and K4 routes' top-{top_k3.shape[1]} lists differ in {bad} rows")
    if valid_k3 != valid_k4:
        raise AssertionError(f"{name}: the K3 and K4 routes' metrics differ")
    for kind, top in (("float32", top_k3), ("bfloat16", top_bf)):
        listed = (mask.gather(1, top >> 3) >> (top & 7).to(torch.uint8)) & 1
        if top.min().item() < 0 or listed[vd.valid].any():
            raise AssertionError(f"{name} {kind}: a pad entry or a train positive is in the top-k")
    for kind, got in (("float32", valid_k3), ("bfloat16", valid_bf)):
        bad = [k for k, v in got.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"{name} {kind}: non-finite metrics {bad}")
    drift = {key: valid_bf[key] - valid_k3[key] for key in ("recall@20", "ndcg@20")}
    off = {k: v for k, v in drift.items() if abs(v) > BF16_METRIC_ATOL}
    if off:
        raise AssertionError(f"{name}: bf16 metrics stray from float32's by more than {BF16_METRIC_ATOL}: {off}")
    agree = float((top_bf == top_k3)[vd.valid].float().mean())
    chunks = vd.users.shape[0] // eval_bs
    print(
        f"{name} evaluate(valid), {vd.n_users_eval} users in {chunks} chunks of {eval_bs}: float32 K3 "
        f"route {res['eval_valid_f32_k3_s']:.3f} s; float32 two-stage K4 route {res['eval_valid_f32_k4_s']:.3f} s; "
        f"bfloat16 fused K5 route {res['eval_valid_bf16_k5_s']:.3f} s [{card}]"
    )
    print(f"{name} evaluation launches: {json.dumps({k: v for k, v in launches.items() if k.startswith('eval')})}")
    print(
        f"{name} checks: K3 and K4 routes' top-{top_k3.shape[1]} lists and metrics equal; no train "
        f"positive listed; bfloat16 lists equal float32's in {agree:.4f} of entries, Recall@20 and NDCG@20 drift "
        f"{json.dumps({k: round(v, 6) for k, v in drift.items()})} (bound {BF16_METRIC_ATOL}); valid {json.dumps(valid_k3)}"
    )
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        def profiled(label, fn):
            sync()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                sync()
                wall = time.perf_counter() - t0
            write_profile(torch, prof, profile_dir, f"{setup.model_name}_{setup.dataset}_{label}", wall, card)

        def switched_eval():
            os.environ["GENMMREC_PALLAS_TOPK"] = "1"
            try:
                trainer.evaluate(vd)
            finally:
                del os.environ["GENMMREC_PALLAS_TOPK"]

        profiled("train_10_steps", lambda: trainer._train_epoch(gen, plan={"idx": perm[1 + steps : 11 + steps]}))
        profiled("eval_valid_f32_k4", switched_eval)
        profiled("eval_valid_bf16_k5", lambda: bf_trainer.evaluate(vd))
    del top_k3, top_k4, top_bf, bf_model, bf_trainer
    res["batch_vs_cpu"] = (
        check_batch_against_cpu(torch, trainer, td, setup.train_ds, config, card) if dev.type == "cuda" else None
    )
    res.update(valid=valid_k3, valid_bf16=valid_bf, metric_drift=drift, bf16_equal_share=agree)
    path_calls = [l for name, l in launches.items() if name != "warmup_step"]
    total = {k: sum(l[k] for l in path_calls) for k in launches["train"]}
    return res, launches, total


def genrecv1_path(torch, dev, card, profile_dir=None):
    """GenRecV1 on Amazon-baby at its published width, through
    ``get_model`` and ``get_trainer``: set-up (the adjacency, R, the two KNN
    graphs, the clustering), its kernels against their plain versions at
    the path's shapes, two epochs of its three phases, one batch against the
    CPU with the dropout masks injected, and the evaluation in float32 and
    bfloat16. Returns (summary, kernel cases by kernel, launches)."""
    from genmmrec_tpu_torch.config import Config
    from genmmrec_tpu_torch.data.arrays import build_eval_data, build_train_data
    from genmmrec_tpu_torch.data.dataset import RecDataset
    from genmmrec_tpu_torch.engine.evaluator import group_masks
    from genmmrec_tpu_torch.engine.trainer import get_trainer
    from genmmrec_tpu_torch.models import get_model
    from genmmrec_tpu_torch.ops.graph import knn_graph_sparse

    out, launches = {}, {}

    def timed(label, fn):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out[f"{label}_s"] = time.perf_counter() - t0
        launches[label] = launch_counts()
        return res

    # -- (a) set-up -----------------------------------------------------
    t0 = time.perf_counter()
    config = Config("GenRecV1", "baby", {"save_recommended_topk": False})
    train_ds, valid_ds, test_ds = RecDataset(config).split()
    eval_bs = int(config["eval_batch_size"])
    td = build_train_data(train_ds, dev)
    vd = build_eval_data(valid_ds, train_ds, eval_bs, dev)
    ted = build_eval_data(test_ds, train_ds, eval_bs, dev)
    config["pop_mask"], config["warm_mask"] = group_masks(train_ds, dev)
    out["data_s"] = time.perf_counter() - t0
    model = timed("model", lambda: get_model("GenRecV1")(config, td))
    model.init_params(torch.Generator(device=dev).manual_seed(SEED))
    model.eval()
    # the two KNN graphs once more, timed apart; the same product and K3 give the model's graphs bit for bit
    for m, feats, g in (("image", model.v_feat, model.image_II), ("text", model.t_feat, model.text_II)):
        again = timed(f"knn_{m}", lambda: knn_graph_sparse(feats, model.knn_k, "sym"))
        if not all(torch.equal(getattr(again, f), getattr(g, f)) for f in ("rows", "cols", "vals")):
            raise AssertionError(f"GenRecV1 {m} KNN graph: a second build differs from the model's")
        if launches[f"knn_{m}"]["grouped_topk"] <= 0:
            raise AssertionError(f"GenRecV1 {m} KNN graph: K3 not launched")
    trainer = timed("trainer", lambda: get_trainer("GenRecV1")(config, model))
    if type(trainer).__name__ != "GenRecV1Trainer" or trainer.debias_tables is None:
        raise AssertionError("get_trainer('GenRecV1') did not give the clustering GenRecV1Trainer")
    out["cluster_s"] = trainer.cluster_s
    for ed in (vd, ted):
        trainer._dense_mask(ed)
    longest = lambda g: int((g.row_ptr[1:] - g.row_ptr[:-1]).max())
    graphs = {"adjacency": model.norm_adj, "R": model.R, "image_knn": model.image_II, "text_knn": model.text_II}
    out["graphs"] = {
        name: dict(n_rows=g.n_rows, n_cols=g.n_cols, nnz=g.nnz, longest_row=longest(g),
                   longest_row_transposed=longest(g.transposed()))
        for name, g in graphs.items()
    }
    tables = trainer.debias_tables
    out["clusters"] = dict(image=int(tables["img_labels"].max()) + 1, text=int(tables["txt_labels"].max()) + 1)
    print(
        f"set-up: GenRecV1/baby users={td.n_users} items={td.n_items} train_inters={td.n_inter} "
        f"graphs {json.dumps(out['graphs'])}; data {out['data_s']:.2f} s (host), model (adjacency, R, both KNN "
        f"graphs) {out['model_s']:.3f} s, KNN graph image {out['knn_image_s']:.3f} s, text {out['knn_text_s']:.3f} s, "
        f"clustering (k-means, image k={out['clusters']['image']}, text k={out['clusters']['text']}, n_init 10) "
        f"{out['cluster_s']:.3f} s [{card}]"
    )

    # -- (b) kernels at the path's shapes ---------------------------------
    trainer.regenerate(trainer.split("smoke", "warm-up"))
    generated = trainer.state["image_ui"]
    f = torch.nn.functional.normalize(model.v_feat, dim=1, eps=1e-12)
    k3 = check_k3(torch, [("genrecv1_knn_image_top10", f @ f.T, model.knn_k, None)], card)["cases"]
    del f
    B = trainer.train_batch_size
    users0 = torch.arange(B, device=dev)
    blended, probs = trainer.generate_chunk(users0, torch.Generator(device=dev).manual_seed(SEED + 3))
    plane = blended * probs
    kth = torch.sort(plane, dim=1, descending=True).values[:, model.rebuild_k - 1 : model.rebuild_k]
    out["rebuild_plane"] = dict(zero_share=float((plane == 0).float().mean()),
                                rows_tied_at_kth=float(((plane == kth).sum(1) > 1).float().mean()))
    k3 += check_k3(
        torch,
        [("genrecv1_gen_top5", probs, min(model.gen_topk, td.n_items), None),
         ("genrecv1_rebuild_top10", plane, model.rebuild_k, None)],
        card,
    )["cases"]
    print(
        f"GenRecV1 regeneration plane (chunk 0): {out['rebuild_plane']['zero_share']:.4f} of blended*probs "
        f"exact zeros, {out['rebuild_plane']['rows_tied_at_kth']:.4f} of rows tie at the k-th value; K3's "
        f"indices equal to the plain version's, index order included [{card}]"
    )
    del blended, probs, plane
    k1 = check_spmm(
        torch,
        [("genrecv1_image_knn_d64", model.image_II, model.latdim),
         ("genrecv1_text_knn_d64", model.text_II, model.latdim),
         ("genrecv1_R_d128", model.R, 2 * model.latdim),
         ("genrecv1_generated_d64", generated, model.latdim)],
        card,
    )["cases"]
    k1_bwd = [
        check_nonsymmetric_grad(torch, model.image_II, model.latdim, card, case="genrecv1_image_knn"),
        check_nonsymmetric_grad(torch, model.R, 2 * model.latdim, card, case="genrecv1_R"),
    ]
    k1_bwd += check_spmm_backward(torch, [("genrecv1_generated_d64", generated, model.latdim)], card)["cases"]
    torch.cuda.empty_cache()

    # -- (c) two epochs, each phase 1, 2 and 3 ----------------------------
    trainer._build_train_step(td)
    unread = ("fusion_weight", "img_weight", "txt_weight")
    epochs = [train_epoch(torch, trainer, epoch, card, unread=unread) for epoch in range(2)]
    for e in epochs:
        if e["bpr_launches"]["segment_spmm"] <= 0 or e["bpr_launches"]["segment_spmm_backward"] <= 0:
            raise AssertionError("GenRecV1: K1 forward or backward not launched in phase 3")
    if profile_dir:
        train_epoch(torch, trainer, 2, card, profile_dir=profile_dir, unread=unread)

    # -- (d) one batch on the card against the CPU ------------------------
    masks = model.dropout_masks(torch.Generator(device=dev).manual_seed(SEED + 4))
    # the linear layers in front of a batch norm: their biases' gradients are zero but for rounding
    zero_grads = {
        n: n[: -len("bias")] + "weight"
        for n, _ in model.named_parameters() if n.endswith("lin.bias") or n == "common1.bias"
    }
    batch_check = check_batch_against_cpu(
        torch, trainer, td, train_ds, config, card, loss_kwargs={"masks": masks}, zero_grads=zero_grads,
        card_graphs=("image_II", "text_II"), replay_branches=True,
    )

    # -- (e) evaluation, float32 (K3) and bfloat16 (fused K5) --------------
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        model.eval_dtype = dtype
        try:
            results[f"valid_{tag}"] = timed(f"eval_valid_{tag}", lambda: trainer.evaluate(vd))
            results[f"test_{tag}"] = timed(f"eval_test_{tag}", lambda: trainer.evaluate(ted, is_test=True))
            top = trainer.eval_topk(ted)
        finally:
            model.eval_dtype = torch.float32
        mask = trainer._dense_mask(ted)
        listed = (mask.gather(1, top >> 3) >> (top & 7).to(torch.uint8)) & 1
        if top.min().item() < 0 or listed[ted.valid].any():
            raise AssertionError(f"GenRecV1 {tag} evaluation: a pad entry or a train positive is in the top-50")
    for key, res in results.items():
        bad = [k for k, v in res.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"GenRecV1 {key}: non-finite metrics {bad}")
    drift = {
        f"{split}_{k}": results[f"{split}_bf16"][k] - results[f"{split}_f32"][k]
        for split in ("valid", "test") for k in ("recall@20", "ndcg@20")
    }
    off = {k: v for k, v in drift.items() if abs(v) > BF16_METRIC_ATOL}
    if off:
        raise AssertionError(f"GenRecV1 bf16 metrics stray from float32's by more than {BF16_METRIC_ATOL}: {off}")
    for label in ("eval_valid_bf16", "eval_test_bf16"):
        need = [n for n in ("fused_group_max", "fused_candidates", "grouped_topk") if launches[label][n] <= 0]
        if need:
            raise AssertionError(f"GenRecV1 {label}: {need} not launched")
    for label in ("eval_valid_f32", "eval_test_f32"):
        if launches[label]["grouped_topk"] <= 0 or launches[label]["fused_group_max"] > 0:
            raise AssertionError(f"GenRecV1 {label}: not the K3 route: {launches[label]}")
    print(
        f"GenRecV1 evaluate: valid f32 {out['eval_valid_f32_s']:.3f} s, test f32 {out['eval_test_f32_s']:.3f} s, "
        f"valid bf16 {out['eval_valid_bf16_s']:.3f} s, test bf16 {out['eval_test_bf16_s']:.3f} s; no train positive "
        f"in any top-50; bf16 - f32 Recall@20/NDCG@20 {json.dumps({k: round(v, 6) for k, v in drift.items()})} "
        f"(bound {BF16_METRIC_ATOL}) [{card}]"
    )
    print(f"GenRecV1 valid f32: {json.dumps(results['valid_f32'])}")
    print(f"GenRecV1 test f32: {json.dumps(results['test_f32'])}")

    # -- (f) launches --------------------------------------------------------
    for e in epochs:
        for phase in ("prelude", "bpr"):
            launches[f"epoch{e['epoch']}_{phase}"] = e[f"{phase}_launches"]
    # the path: the model's set-up (its KNN graphs), the trainer's (the
    # clustering), the epochs and the evaluations; not the KNN graphs' second build
    path = {k: v for k, v in launches.items() if not k.startswith("knn_")}
    total = {k: sum(l[k] for l in path.values()) for k in launch_counts()}
    for name in ("segment_spmm", "segment_spmm_backward", "grouped_topk", "fused_group_max", "fused_candidates"):
        if total[name] <= 0:
            raise AssertionError(f"GenRecV1: {name} never launched on its path")
    print(f"GenRecV1 launches: {json.dumps(launches)}")
    strip = lambda e: {k: v for k, v in e.items() if not k.endswith("_launches")}
    summary = dict(**out, epochs=[strip(e) for e in epochs], results=results, bf16_metric_drift=drift,
                   batch_vs_cpu=batch_check, launches=launches)
    del trainer, model
    torch.cuda.empty_cache()
    return summary, dict(k1=k1, k1_bwd=k1_bwd, k3=k3), total


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1

    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--profile", metavar="DIR",
        help="profile one more bf16 evaluation and one more epoch of DiffMM, phase by phase, and ten more "
        "training batches and two more evaluations of LightGCN, into DIR",
    )
    parser.add_argument(
        "--k5a-against", nargs="+", metavar="DIR",
        help="only time this checkout's K5a against the K5a of each other checkout DIR, in turns, and stop",
    )
    args = parser.parse_args()
    smoke_t0 = time.perf_counter()

    from genmmrec_tpu_torch.config import Config
    from genmmrec_tpu_torch.data.arrays import build_eval_data, build_train_data
    from genmmrec_tpu_torch.data.dataset import RecDataset
    from genmmrec_tpu_torch.engine.diffusion_trainers import DiffMMTrainer
    from genmmrec_tpu_torch.engine.evaluator import group_masks
    from genmmrec_tpu_torch.ops.precision import full_precision_matmuls
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
    if args.k5a_against:
        print(json.dumps({"k5a_against": k5a_against(torch, args.k5a_against, card)}))
        return 0

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
    k1 = check_spmm(
        torch,
        [
            ("adjacency_d64", model.norm_adj, model.latdim),
            ("adjacency_d128", model.norm_adj, 2 * model.latdim),
            ("regenerated_modal_graph_d64", modal, model.latdim),
        ],
        card,
    )
    k1_bwd = check_spmm_backward(
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
    # the same at the Amazon-elec catalog width, the float32 evaluation's
    # plane there and the same in bfloat16
    wide_mask = elec_mask(torch, eval_bs, ELEC_ITEMS, ELEC_POSITIVES, SEED, dev)
    wide = torch.randn(eval_bs, ELEC_ITEMS, generator=gen, device=dev)
    k3_wide = check_k3(torch, [("elec_top50_masked", wide, 50, wide_mask)], card)
    wide = wide.bfloat16()
    k3_wide["cases"] += check_k3(torch, [("elec_top50_masked_bf16", wide, 50, wide_mask)], card)["cases"]
    del wide
    k3["cases"] += k3_wide["cases"]
    # k past the threshold path: the radix path, ranked in the kernel up to
    # 512 and sorted by the wrapper past it
    plane = torch.randn(eval_bs, td.n_items, generator=gen, device=dev)
    k3["cases"] += check_k3(
        torch,
        [
            (f"eval_top{kk}_masked{'' if dtype == torch.float32 else '_bf16'}", plane.to(dtype), kk, eval_mask)
            for dtype in (torch.float32, torch.bfloat16) for kk in (65, WIDE_K, 256, 257, 1000)
        ],
        card,
    )["cases"]
    del plane
    check_k3_adversarial(torch, dev)
    k5 = check_k5(
        torch,
        [
            ("baby", td.n_items, model.latdim, eval_mask),
            ("elec", ELEC_ITEMS, model.latdim, elec_mask(torch, eval_bs, ELEC_ITEMS, ELEC_POSITIVES, SEED, dev)),
        ],
        trainer.evaluator.max_k,
        card,
    )
    k3["cases"] += k5["grouped_topk_bf16"]["cases"]
    torch.cuda.empty_cache()

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

    # the regeneration again with GENMMREC_PALLAS_TOPK set: its top-rebuild_k
    # (top-1) takes the two-stage route, K4 at kp = k = 1; the graphs must be
    # the ones K3's top-1 built
    built = {name: trainer.state[name] for name in ("image_ui", "text_ui")}
    reset_counts()
    os.environ["GENMMREC_PALLAS_TOPK"] = "1"
    try:
        t0 = time.perf_counter()
        trainer.regenerate()
        torch.cuda.synchronize()
        t_regen_switched = time.perf_counter() - t0
    finally:
        del os.environ["GENMMREC_PALLAS_TOPK"]
    switched_launches = launch_counts()
    for name in ("masked_group_max", "grouped_topk", "candidate_extract"):
        if switched_launches[name] <= 0:
            raise AssertionError(f"{name} was not launched during the switched regeneration")
    for name, g in built.items():
        sw = trainer.state[name]
        if not all(torch.equal(getattr(g, f), getattr(sw, f)) for f in ("row_ptr", "rows", "cols", "vals")):
            raise AssertionError(f"{name}: the switched regeneration built another graph than K3's top-1")
    print(
        f"regenerate with GENMMREC_PALLAS_TOPK set (K4 at kp = k = {model.rebuild_k}): {t_regen_switched:.3f} s, "
        f"both modal graphs equal to K3's; launches {json.dumps(switched_launches)} [{card}]"
    )

    # -- phase 4: the bf16 evaluation path --------------------------------
    bf16_eval = bf16_evaluation_path(torch, config, td, vd, ted, model, valid_res, test_res, card, args.profile)
    bf16_launches = bf16_eval.pop("launches")

    # -- phase 5: the training path ---------------------------------------
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

    # -- phase 6: the gradient of a graph that is not symmetric ------------
    from genmmrec_tpu_torch.ops.graph import ui_norm_adj

    ui = ui_norm_adj(train_ds.table.users, train_ds.table.items, td.n_users, td.n_items, dev)
    nonsymmetric = check_nonsymmetric_grad(torch, ui, model.latdim, card)
    k1_bwd["cases"].append(nonsymmetric)
    unsorted = check_unsorted_spmm(torch, model.norm_adj, model.latdim, card)
    del trainer, model, ui
    torch.cuda.empty_cache()

    # -- phase 6b: an embedding wider than the fused kernels', and a model
    # with scores alone, on the baby data ------------------------------------
    wide_res, wide_calls = wide_embedding_path(torch, td, vd, config, card)
    wide_launches = {k: sum(l[k] for l in wide_calls.values()) for k in serving_launches}
    torch.cuda.empty_cache()

    # -- phase 6c: GenRecV1 on Amazon-baby ---------------------------------
    genrec_t0 = time.perf_counter()
    genrec, genrec_cases, genrec_launches = genrecv1_path(torch, dev, card, args.profile)
    k1["cases"] += genrec_cases["k1"]
    k1_bwd["cases"] += genrec_cases["k1_bwd"]
    k3["cases"] += genrec_cases["k3"]
    genrec["phase_s"] = time.perf_counter() - genrec_t0
    print(f"GenRecV1/baby phase done in {genrec['phase_s']:.1f} s")

    # -- phase 7: LightGCN at the Amazon-elec geometry ----------------------
    # the adjacency there takes K2, and the catalog is wide enough for the
    # two-stage top-k (K4): both kernels against their plain versions at the
    # path's shapes first, then the path
    elec_t0 = time.perf_counter()
    elec = graph_cf_setup(torch, dev)
    adj = elec.model.norm_adj
    if not adj.blocked or elec.td.n_items != ELEC_ITEMS:
        raise AssertionError(f"the elec adjacency ({adj.n_rows} rows) must take K2 over a catalog of {ELEC_ITEMS}")
    d = elec.model.latent_dim
    k2 = check_spmm(torch, [("elec_adjacency_d64", adj, d), ("elec_adjacency_d128", adj, 2 * d)], card, blocked=True)
    k2_bwd = check_spmm_backward(
        torch, [("elec_adjacency_d64", adj, d), ("elec_adjacency_d128", adj, 2 * d)], card, blocked=True
    )
    check_spmm_widths(torch, dev)
    k4 = check_k4(torch, elec.eval_bs, ELEC_ITEMS, elec.trainer.evaluator.max_k, ELEC_POSITIVES, card)
    for kk in (WIDE_K, UNSTAGED_K):
        k4["cases"] += check_k4(torch, elec.eval_bs, ELEC_ITEMS, kk, ELEC_POSITIVES, card)["cases"]
    check_k4_adversarial(torch, dev)
    torch.cuda.empty_cache()
    elec_res, elec_calls, elec_launches = graph_cf_path(torch, elec, card, profile_dir=args.profile)
    print(f"LightGCN/elec phase done in {time.perf_counter() - elec_t0:.1f} s")

    launches = {
        k: serving_launches[k] + switched_launches[k] + bf16_launches[k] + training_launches[k] + wide_launches[k]
        + elec_launches[k] + genrec_launches[k]
        for k in serving_launches
    }
    never = [k for k, v in launches.items() if v <= 0]
    if never:
        raise AssertionError(f"kernels launched on no path: {never}")
    fused_src = "genmmrec_tpu_torch/csrc/fused_topk.cu"
    blocked_src = "genmmrec_tpu_torch/csrc/segment_blocked.cu"
    kernels = [
        dict(
            name="segment_spmm", route="cuda", source="genmmrec_tpu_torch/csrc/segment_sum.cu",
            replaces="genmmrec_tpu/ops/segment_pallas.py:395", launches=launches["segment_spmm"], **k1,
        ),
        dict(
            name="segment_spmm_backward", route="cuda", source="genmmrec_tpu_torch/csrc/segment_sum.cu",
            replaces="genmmrec_tpu/ops/segment_pallas.py:395 (from _sym_bwd :442 and _bwd :418)",
            launches=launches["segment_spmm_backward"], **k1_bwd,
        ),
        dict(
            name="segment_spmm_blocked", route="cuda", source=blocked_src,
            replaces="genmmrec_tpu/ops/segment_pallas.py:247", launches=launches["segment_spmm_blocked"], **k2,
        ),
        dict(
            name="segment_spmm_blocked_backward", route="cuda", source=blocked_src,
            replaces="genmmrec_tpu/ops/segment_pallas.py:247 (from _sym_blk_bwd :296)",
            launches=launches["segment_spmm_blocked_backward"], **k2_bwd,
        ),
        dict(
            name="grouped_topk", route="cuda", source="genmmrec_tpu_torch/csrc/topk.cu",
            replaces="genmmrec_tpu/ops/topk.py:135", launches=launches["grouped_topk"], **k3,
        ),
        dict(
            name="candidate_extract", route="cuda", source="genmmrec_tpu_torch/csrc/topk_extract.cu",
            replaces="genmmrec_tpu/ops/topk.py:168", launches=launches["candidate_extract"],
            fold_launches=launches["masked_group_max"], **k4,
        ),
        dict(
            name="fused_group_max", route="cuda", source=fused_src,
            replaces="genmmrec_tpu/ops/fused_topk.py:293", launches=launches["fused_group_max"],
            **k5["fused_group_max"],
        ),
        dict(
            name="fused_candidates", route="cuda", source=fused_src,
            replaces="genmmrec_tpu/ops/fused_topk.py:329", launches=launches["fused_candidates"],
            **k5["fused_candidates"],
        ),
        dict(
            name="fused_candidates_unmasked", route="cuda", source=fused_src,
            replaces="genmmrec_tpu/ops/fused_topk.py:312", launches=launches["fused_candidates_unmasked"],
            **k5["fused_candidates_unmasked"],
        ),
    ]
    strip = lambda e: {k: v for k, v in e.items() if not k.endswith("_launches")}
    summary = dict(
        regenerate_s=t_regen, eval_valid_s=t_valid, eval_test_s=t_test, regenerate_switched_s=t_regen_switched,
        launches_regenerate_switched=switched_launches,
        train_epochs=[strip(e) for e in epochs], train_eval_valid_s=t_train_valid,
        launches_serving=serving_launches, launches_bf16_eval=bf16_launches,
        launches_training=training_launches, bf16_eval=bf16_eval,
        fused_grouped_topk=k5["fused_grouped_topk"], batch_vs_cpu=batch_check,
        nonsymmetric_grad=nonsymmetric, unsorted_spmm=unsorted, lightgcn_baby_d192=wide_res,
        launches_lightgcn_baby_d192=wide_calls, lightgcn_elec=elec_res, launches_lightgcn_elec=elec_calls,
        genrecv1_baby=dict(**genrec, launches_total=genrec_launches), card=card,
        total_s=time.perf_counter() - smoke_t0,
    )
    print(f"chip_smoke: all paths and checks done in {summary['total_s']:.1f} s [{card}]")
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
