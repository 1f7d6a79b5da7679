#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (genmmrec_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]
    python3 chip_smoke.py --k5a-against DIR [DIR ...]
    python3 chip_smoke.py --mp-only [--profile DIR]
    python3 chip_smoke.py --mmg-only [--profile DIR]
    python3 chip_smoke.py --diff-only [--profile DIR]
    python3 chip_smoke.py --rf-only [--profile DIR]
    python3 chip_smoke.py --mesh-only
    python3 chip_smoke.py --elec-only [--profile DIR]
    python3 chip_smoke.py --zoo-only
    python3 chip_smoke.py --tools-only

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

DiffRec, LD4MRec, GenRecV1 and DiffMM at the Amazon-elec tier after it
(``elec_path``), on the same interactions and the tier's seeded features,
each through ``get_model`` and ``get_trainer`` at its published YAML: the
set-up timed apart (LD4MRec's ``svds`` of R, GenRecV1's two KNN graphs
over 63,001 items and its clustering), one epoch of every phase (GenRecV1's
and DiffMM's phase 3 and DiffRec's and LD4MRec's epoch cut to
``ELEC_BATCHES`` of their 627 batches by a batch plan; the denoisers' phase
and the regeneration whole) and evaluate(valid) and evaluate(test) in
float32 (DiffRec's valid alone, on its first 32,768 users,
``ELEC_VALID_ONLY``), with finite losses and
metrics and no train positive in a top-50; K3 on GenRecV1's KNN block
(8,192 x 63,001, k = 10) and regeneration planes (k = 5 and 10) and on
DiffMM's top-1 plane, K1 on both KNN graphs and R (192,403 rows), K2 on
GenRecV1's generated graph and DiffMM's two modal graphs (255,404 rows)
and K2's backward on one, each against its plain version; DiffMM's
``remat_gcn`` on at elec, one batch with remat on against remat off (the
loss equal, the gradients within the card-vs-CPU bound, both peak
memories) and one batch against the CPU. ``--elec-only`` builds the
kernels and runs this phase alone.

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

The CLI, on Amazon-baby at the published widths: ``quick_start`` of
FREEDOM (two epochs; K1 over its item graph and its pruned user-item
graph, forward and backward; its graphs' K1 against the plain version and
one batch against the CPU), BM3 (one epoch), VBPR under ``mg`` (the three
combinations of ``mg.yaml``) and ItemKNNCBF (its similarity's top-k, K3,
against the plain version), each timed by set-up, epoch and evaluation;
then ``python -m genmmrec_tpu_torch --model FREEDOM --dataset baby`` with
bfloat16 evaluation in a child process that names no device, which must
run on the card (K5a and K5b launched) and print the BEST block.

The message-passing models last (``mp_path``), on Amazon-baby at the
published widths through ``quick_start``, one epoch and ``evaluate`` of
valid and test each: MMGCN, GRCN, DualGNN (float32, then bfloat16: K5a and
K5b), DRAGON, COHESION and MVGAE, each timed by set-up, epoch and
evaluation; K1 through ``ops/mp.py`` ``propagate`` (``mean``) against its
plain version on MMGCN's user-item graph at d = 64, 256 and 384 and on
MVGAE's self-looped one, forward and x-gradient; GRCN's edge-weight
gradient, and GRCN's and MVGAE's batch (MVGAE's draws made on the card),
on the card against the CPU; DualGNN's user co-occurrence graph (``R @
Rᵀ`` and K3's top-40) against its build on the CPU and against scipy's
sparse counts; K3 on a block of counts against its plain version.
``--mp-only`` builds the kernels and runs this phase alone.

The host tools after them (``prep_path``): a raw ratings CSV and a gzipped
meta file written from a seed (the synthetic baby table topped up to a
5-core of 19,445 users and 7,050 items, with several times its rows of
noise that the 5-core drops in its first or second round, repeats and
blank timestamps), then the port's preprocessing CLI ``rating2inter`` →
``split`` → ``reindex-feat`` → ``encode-feat`` → ``uu-graph`` (its counts
as products of a sparse R and dense blocks on the card and K3's top-200),
each step timed on the host; the
5-core against the core and a plain k-core; the user graph against the
port's build on the CPU over 2,048 users and scipy's counts over all, K3 on
a (2,048, 19,445) block at k = 200 against its plain version; the
``.inter`` read back by the native parser and by ``csv`` (equal, times in
step with the rows, both timed); the train history built by the native
library and by numpy (equal, both timed); DualGNN/baby through ``quick_start`` from
those files alone (no synthetic fallback), its user graph read from the
file against ``cooccurrence_topk``; ``data_utils`` on the card
(``ImageResize`` against the CPU, the MLM masking's shares).
``--prep-only`` builds the kernels and runs this phase alone.

The last multimodal graph models after them (``mmg_path``), the same way:
GUME, LATTICE, MGCN (float32, then bfloat16: K5a and K5b), LGMRec, SMORE,
PGL, SLMRec and DAMRS. LATTICE's per-step top-k of its learned
similarity: K3 on that plane against its plain version and ``torch.topk``,
the learned graph's gradient on the card against the CPU, three training
batches that must launch K3 twice each, with their peak memory; LATTICE's
and SLMRec's batch on the card against the CPU (LATTICE's CPU takes the
card's original planes and top-k columns); SMORE's fusion graph against
its CPU build and K3 at its k = 40; DAMRS's co-occurrence neighbours
against the CPU's build and scipy's counts, and K3 on a block of counts;
K1 forward and backward on GUME's augmented graph (not symmetric) and
forward on SMORE's fusion graph. ``--mmg-only`` builds the kernels and
runs this phase alone.

The diffusion recommenders last (``diff_path``), the same way: DiffRec,
LD4MRec, DDRM, DiffGraph (float32, then bfloat16: K5a and K5b), MCDRec,
CoDMR and MVDiff (through ``MVDiffTrainer``: feature diffusion, the item
graphs' rebuild, sparsity diffusion, the user-item graphs' rebuild, then
the BPR epoch), each with one training batch's launches and Recall@20
beside the JAX package's two-epoch smoke value; DiffRec's evaluation
beside its float32 bound; DiffRec's and MCDRec's batch on the card against
the CPU (draws made on the card); MCDRec's graph after its
diffusion-guided resampling under K1, forward and backward; K1 through
DiffGraph's ``propagate`` and on CoDMR's self-looped graph; K3 on CoDMR's
KNN rows; MVDiff's phase 4 again, its user-item graphs held equal to
those the plain top-k builds on the same denoised rows, and K3 on its
tie-heavy high-order rows and its denoised scores. ``--diff-only`` builds
the kernels and runs this phase alone.

The Rectified-Flow family last (``rf_path``), the same way, the YAML's
``rf_loss_weight`` set to 0.2: RFGUME, RFGUMETime, RFMRec, GenRecBM3,
RFBM3 and the 14 thin RF hosts, then RFGUMETime and GenRecBM3 with
``rf_warmup_epochs`` 0 (the generated term reaches the scores) and RFBM3
with bfloat16 evaluation (K5a and K5b), each with one training batch's
launches and Recall@20 beside the JAX package's two-epoch smoke value;
RFGUME's and RFMRec's batch on the card against the CPU (every gradient,
the ``rf`` subtree's too, and the parameters after the main
optimizer and the ``"rf"`` AdamW stepped); K1 on R at d = 64 and, cut into
column slices, at d = 4,096; K1 on RFMRec's weighted adjacency forward and
backward and on the causal denoiser's edge layout with one batch's values;
the ``"rf"`` parameters moved by the epoch and untouched by the main
optimizer alone. ``--rf-only`` builds the kernels and runs this phase
alone.

The multi-device layer after them (``mesh_path``): four ranks of a ``{data: 2,
model: 2}`` mesh share the card over gloo (``parallel.launch.run``), each
running DiffMM on Amazon-baby through ``get_model`` and ``get_trainer``:
one ``fit`` epoch (phase 1 and the BPR epoch split over the data axis, the
regeneration's chunks dealt over it, the optimizers' rows split over the
model axis), evaluate(valid) and evaluate(test) in float32 and in
bfloat16 (K3 on each rank's item shard, ``sharded_topk``); one batch's
gradients summed over the data axis against the same batch on one rank;
each rank's K3 on its shard against its plain version; the layer's
collectives timed. The same seed on one rank in this process: every metric
within ``MESH_METRIC_ATOL``. The same world then fits MGCN and MVDiff
(its four phases through ``MVDiffTrainer``, each timed beside one rank's)
on baby at their published configs one epoch and evaluates the valid split
in float32, each against one rank's fit (every metric within
``MESH_METRIC_ATOL``), and runs one training batch of each of the 45
models besides BPR, LightGCN, DiffMM, GenRecV1 and DiffRec
(``MESH_FAMILY_MODELS``), on baby, the same parameters, batch and draws on
every rank: the loss summed over the data axis and the summed gradients
against the global batch on one rank, and each rank's launches (K1
forward and backward for every model that propagates, K3 in LATTICE's,
DAMRS's and RFLATTICE's steps). Then the spectral
clustering of baby's fused features (``multimodal_fusion_cluster``, K3 on
the 7,050² similarity) on the card against the CPU. ``--mesh-only`` builds
the kernels and runs this phase alone.

The zoo sweep last (``zoo_path``): ``scripts/zoo_sweep_torch.py`` trains
LightGCN, FREEDOM and DiffMM one epoch each on Amazon-baby through ``python
-m genmmrec_tpu_torch``, three child processes at once, and beside them
DiffMM one epoch on Amazon-sports (35,598 × 18,357) through a second call:
and DiffMM one epoch on MicroLens (98,129 × 17,228, ``remat_gcn`` on)
through a third: every row OK, its Recall@20 finite, each child's K1 and
K3 launched. Then K1 forward and backward on the sports adjacency and K3
on a masked sports evaluation chunk and on DiffMM's sports regeneration
plane against their plain versions (``zoo_sports_kernels``), and K1
forward and backward on the microlens adjacency, ``graph.spmm`` at d = 768
on it (a 512 and a 256 slice), K3 on a masked microlens evaluation chunk
and on a tie-heavy (2,048, 98,129) block of DualGNN's co-occurrence counts
(``zoo_microlens_kernels``). Then
``scripts/make_structured_dataset_torch.py`` at its default size (4,000 ×
2,000) with its user graph on the card: the files byte-equal to a numpy
re-derivation, the user graph against scipy's counts and K3 at k = 200
against its plain version; then ``scripts/zoo_report_torch.py`` on the
journal. ``--zoo-only`` builds the kernels and runs this phase alone.

The experiment tools after it (``tools_path``): the baby LightGCN
checkpoint of one ``python -m genmmrec_tpu_torch`` epoch, its loss landscape
(``scripts/visualize_landscape_torch.py``'s ``loss_grid``, 11 × 11 points)
through K1 and again through the plain versions on the card, within
``LANDSCAPE_RTOL``, the parameters equal to the checkpoint's bit for bit
afterwards; beside it one harness child, ``scripts/run_rf_models_torch.py
-d baby --models RFBM3 --use_rf false --epochs 1`` (its YAML grid of three),
with K1 and K3 launched and a finite BEST block. ``--tools-only`` builds the
kernels and runs this phase alone.

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
import re
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
# a top-k inside the loss (LATTICE's per step) on the card and on the CPU:
# at most this share of its rows may choose other columns on the two
# devices (near-equal similarities), and the CPU then takes the card's
TOPK_ROW_SHARE = 1e-2
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


def k3_tie_sets(torch, s, v, i, v_ref, i_ref, name):
    """K3's top-k of unmasked rows held with its ties as sets: the values
    equal, each index pointing at its value, no index twice in a row, and
    each row's indices above its k-th value the plain version's. Returns
    (rows whose k-th value is tied past the cut, rows whose indices differ
    from the plain version's)."""
    fin = torch.isfinite(v_ref)
    if not torch.equal(torch.isfinite(v), fin) or not torch.equal(v[fin], v_ref[fin]):
        raise AssertionError(f"K3 {name}: values differ")
    if not torch.equal(s.gather(1, i.long())[fin], v[fin]):
        raise AssertionError(f"K3 {name}: an index does not point at its value")
    srt = i.sort(dim=1).values
    if bool((srt[:, 1:] == srt[:, :-1]).any()):
        raise AssertionError(f"K3 {name}: an index twice in a row")
    kth = v_ref[:, -1:]
    above = lambda vals, idx: torch.where(vals > kth, idx, -1).sort(dim=1).values
    if not torch.equal(above(v, i), above(v_ref, i_ref)):
        raise AssertionError(f"K3 {name}: the indices above a row's k-th value differ")
    tied = int(((s == kth).sum(dim=1) > (v_ref == kth).sum(dim=1)).sum())
    return tied, int((i != i_ref).any(dim=1).sum())


def check_k3(torch, cases_in, card, ties_as_sets=False):
    """K3 against its plain version on each (name, scores, k, mask) case:
    indices equal, values equal where finite; with ``ties_as_sets`` (rows
    without a mask) the ties held as sets (``k3_tie_sets``)."""
    from genmmrec_tpu_torch.ops.topk import grouped_topk, grouped_topk_plain, unpack_mask

    cases, err, ms, plain_ms, lib_ms, bound = [], 0.0, 0.0, 0.0, 0.0, Bound()
    for name, s, k, m in cases_in:
        v, i = grouped_topk(s, k, packed_mask=m)
        v_ref, i_ref = grouped_topk_plain(s, k, packed_mask=m)
        torch.cuda.synchronize()
        fin = torch.isfinite(v_ref)
        ties = {}
        if ties_as_sets:
            ties["tied_rows"], ties["rows_ordered_otherwise"] = k3_tie_sets(torch, s, v, i, v_ref, i_ref, name)
        elif not torch.equal(i, i_ref):
            bad = (i != i_ref).any(dim=1).sum().item()
            raise AssertionError(f"K3 {name}: indices differ in {bad} rows")
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
        held = (
            f"ties held as sets ({ties['tied_rows']} rows tied past the k-th value, "
            f"{ties['rows_ordered_otherwise']} rows in another order than plain)" if ties else "indices equal"
        )
        print(
            f"K3 {name}: scores {tuple(s.shape)} {str(s.dtype).split('.')[-1]} k={k} "
            f"mask={'yes' if m is not None else 'no'} {held}, max_abs_err={e:.3e} kernel {k_ms:.4f} ms, "
            f"plain {p_ms:.4f} ms, torch.topk {l_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}) [{card}]"
        )
        cases.append(dict(
            case=name, shape=list(s.shape), dtype=str(s.dtype).split(".")[-1], k=k, max_abs_err=e,
            ms=k_ms, plain_ms=p_ms, library_ms=l_ms, **ties, **b,
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
    """name -> the wrapper whose ``launches`` counts that kernel's launches
    (``genmmrec_tpu_torch.ops.KERNEL_WRAPPERS``)."""
    import importlib

    from genmmrec_tpu_torch.ops import KERNEL_WRAPPERS

    return {name: getattr(importlib.import_module(f"genmmrec_tpu_torch.ops.{mod}"), name)
            for mod, names in KERNEL_WRAPPERS.items() for name in names}


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


def batch_optimizers(model, trainer):
    """Copies of the optimizers ``trainer`` steps after a batch (the main
    one and each group of the model's ``label_transforms``), state
    included, over ``model``'s parameters on its device."""
    from genmmrec_tpu_torch.engine.trainer import make_optimizer

    groups = model.param_groups()
    made = {"main": lambda: make_optimizer(groups["rec"], trainer.config, trainer._num_batches)}
    made.update({k: (lambda make=make, k=k: make(groups[k])) for k, make in model.label_transforms().items()})
    opts = []
    for name in trainer._batch_steps:
        opt = made[name]()
        opt.load_state_dict(trainer.optimizers[name].state_dict())
        opts.append(opt)
    return opts


def seeded_batch(torch, trainer, td, seed):
    """One training batch of the trainer's size from a seeded permutation of
    the interactions, its negatives drawn, the last eighth padding weighted
    0 (as the epoch's last batch has)."""
    from genmmrec_tpu_torch.data.arrays import sample_negatives

    gen = torch.Generator(device=td.device).manual_seed(seed)
    B = trainer.train_batch_size
    idx = torch.randperm(td.n_inter, generator=gen, device=td.device)[:B]
    users, pos = td.users[idx], td.items[idx]
    neg = sample_negatives(users, td.hist, td.item_pool, td.n_pool, trainer.neg_rounds, gen)
    weight = torch.ones(B, device=td.device)
    weight[-B // 8 :] = 0.0
    return {"users": users, "pos": pos, "neg": neg, "weight": weight}


def check_batch_against_cpu(
    torch, trainer, td, train_ds, config, card, loss_kwargs=None, zero_grads=None, card_graphs=(), replay_branches=False,
    card_tensors=(), replay_topk=False, groups=("rec",), step=False, card_derived=(),
):
    """One training batch on the card and on the CPU, from the same
    parameters, state and batch: the loss and every gradient of the
    parameter ``groups`` (``rec``, the main optimizer's, by default). With
    ``step``, each device then steps copies of the trainer's batch
    optimizers (the main one and the model's ``label_transforms``, their
    state included) and each parameter after the step is held at the
    gradients' bound, but for those of ``zero_grads``.

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
    The graphs named in ``card_derived`` are built from those (GUME's
    augmented graph and its R, from the two KNN graphs' common pairs): the
    CPU takes the card's. The dense planes named in ``card_tensors`` (LATTICE's original KNN
    graphs) must share CARD_GRAPH_SHARE of their nonzero pattern, and the
    CPU takes the card's.

    With ``replay_topk`` the CPU takes the card's columns of every top-k of
    the loss (``ops.graph.grouped_topk``: LATTICE's per-step KNN of its
    learned similarity, whose near-equal neighbours either device may rank
    first) and gathers its own values there; the rows whose own columns
    differ are counted and may be at most TOPK_ROW_SHARE of all.

    With ``replay_branches`` the CPU takes each ``leaky_relu`` entry's slope
    as the card took it, where the two devices' pre-activations lie on two
    sides of 0: an entry within rounding of 0 may take the other slope on
    one device, whose gradient differs by 0.8 of its cotangent (not a
    rounding difference). Such an entry must lie within FLIP_RTOL of its
    tensor's largest magnitude on both devices, and such entries may be at
    most FLIP_SHARE of all."""
    from genmmrec_tpu_torch.data.arrays import build_train_data
    from genmmrec_tpu_torch.ops.graph import SparseGraph

    model, cpu = trainer.model, torch.device("cpu")
    B = trainer.train_batch_size
    batch = seeded_batch(torch, trainer, td, SEED + 2)
    cpu_model = type(model)(config, build_train_data(train_ds, cpu))
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu_state = {k: g.to(cpu) if hasattr(g, "to") else g for k, g in trainer.state.items()}
    edges_equal = {}
    for name, g in vars(model).items():
        if not isinstance(g, SparseGraph):
            continue
        own = getattr(cpu_model, name)
        same_rows = own.nnz == g.nnz and bool(torch.equal(own.rows, g.rows.cpu()))
        edges_equal[name] = float((own.cols == g.cols.cpu()).float().mean()) if same_rows else 0.0
        if name in card_derived:
            setattr(cpu_model, name, g.to(cpu))
        elif name in card_graphs:
            if edges_equal[name] < CARD_GRAPH_SHARE:
                raise AssertionError(f"{name}: the CPU's graph shares {edges_equal[name]} of the card's edges")
            setattr(cpu_model, name, g.to(cpu))
        elif edges_equal[name] != 1.0 or not torch.equal(own.vals, g.vals.cpu()):
            raise AssertionError(f"{name}: the CPU's graph differs from the card's (edges equal {edges_equal[name]})")
    for name in card_tensors:
        theirs = getattr(model, name).cpu()
        edges_equal[name] = float(((getattr(cpu_model, name) != 0) == (theirs != 0)).float().mean())
        if edges_equal[name] < CARD_GRAPH_SHARE:
            raise AssertionError(f"{name}: the CPU's plane shares {edges_equal[name]} of the card's pattern")
        setattr(cpu_model, name, theirs)
    held = model.param_groups()
    rec_names = {id(p) for g in groups for p in held[g]}

    def to_cpu(v):
        if torch.is_tensor(v):
            return v.cpu()
        if isinstance(v, dict):
            return {k: to_cpu(x) for k, x in v.items()}
        if isinstance(v, (tuple, list)):
            return tuple(to_cpu(x) for x in v)
        return v

    loss_kwargs = loss_kwargs or {}
    cpu_kwargs = to_cpu(loss_kwargs)

    def loss_and_grads(m, state, b, kwargs):
        m.zero_grad(set_to_none=True)
        with torch.enable_grad():
            total, _ = m.loss(state, b, **kwargs)
            total.backward()
        names = [n for n, p in model.named_parameters() if id(p) in rec_names]
        params = dict(m.named_parameters())
        grads = {n: params[n].grad.detach().cpu() for n in names if params[n].grad is not None}
        if step:
            for opt in batch_optimizers(m, trainer):
                opt.step()
            stepped.append({n: params[n].detach().cpu().clone() for n in names})
        return total.item(), grads

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

    import genmmrec_tpu_torch.ops.graph as G

    topk, picked, topk_rows = G.grouped_topk, [], dict(rows=0, differ=0)

    def recording_topk(scores, k, **kw):
        v, i = topk(scores, k, **kw)
        picked.append(i)
        return v, i

    def replaying_topk(scores, k, **kw):
        _, own = topk(scores, k, **kw)
        card_i = picked.pop(0).cpu()
        topk_rows["rows"] += own.shape[0]
        topk_rows["differ"] += int((own.sort(1).values != card_i.sort(1).values).any(1).sum())
        return scores.gather(1, card_i), card_i

    stepped = []
    card_params = {n: p.detach().clone() for n, p in model.named_parameters()} if step else {}
    t0 = time.perf_counter()
    try:
        if replay_branches:
            F.leaky_relu = recording
        if replay_topk:
            G.grouped_topk = recording_topk
        loss_gpu, g_gpu = loss_and_grads(model, trainer.state, batch, loss_kwargs)
        if replay_branches:
            F.leaky_relu = replaying
        if replay_topk:
            G.grouped_topk = replaying_topk
        loss_cpu, g_cpu = loss_and_grads(cpu_model, cpu_state, {k: v.cpu() for k, v in batch.items()}, cpu_kwargs)
    finally:
        F.leaky_relu = leaky_relu
        G.grouped_topk = topk
    model.zero_grad(set_to_none=True)
    if step:
        # the card's parameters as they were: the batch is a check
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(card_params[n])
    rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    if g_gpu.keys() != g_cpu.keys():
        raise AssertionError(f"rec gradients of other parameters on the two devices: {g_gpu.keys() ^ g_cpu.keys()}")
    worst, worst_step = {}, {}
    zero_grads = zero_grads or {}

    def share(ours, ref):
        bound = GRAD_RTOL * ref.abs() + GRAD_ATOL * ref.abs().max()
        return float(((ours - ref).abs() / bound.clamp(min=1e-30)).max())

    for n, ref in g_cpu.items():
        if n in zero_grads:
            scale = GRAD_ATOL * g_cpu[zero_grads[n]].abs().max()
            worst[n] = float(max(ref.abs().max(), g_gpu[n].abs().max()) / scale)
            continue
        worst[n] = share(g_gpu[n], ref)
    if step:
        # a gradient zero but for rounding makes a full Adam step of noise:
        # such a parameter is not held after the step
        for n, ref in stepped[1].items():
            if n not in zero_grads:
                worst_step[n] = share(stepped[0][n], ref)
    replayed = (
        f"; leaky_relu: {flips['flipped']} of {flips['entries']} entries on other sides of 0 on the two devices, "
        f"the CPU took the card's slope there (the largest such pair {flips['worst_flip']:.2e} of its tensor's "
        f"largest magnitude, bound {FLIP_RTOL:.0e}; any entry's largest difference {flips['worst_apart']:.2e})"
        if replay_branches else ""
    )
    if replay_topk:
        replayed += (
            f"; the loss's top-k: the CPU took the card's columns, its own differ on {topk_rows['differ']} of "
            f"{topk_rows['rows']} rows"
        )
    if step:
        replayed += (
            f"; after a step of {trainer._batch_steps} (copies with the trainer's state), the parameters, largest "
            f"share of the bound per tensor {json.dumps({k: round(v, 4) for k, v in worst_step.items()})}"
        )
    print(
        f"card vs CPU, {type(model).__name__}, one batch of {B}: loss {loss_gpu:.7f} vs {loss_cpu:.7f} (rel {rel:.2e}, "
        f"bound {LOSS_RTOL:.0e}); {'+'.join(groups)} gradients, largest share of the bound per tensor "
        f"{json.dumps({k: round(v, 4) for k, v in worst.items()})} in {time.perf_counter() - t0:.1f} s; the "
        f"model's graphs built on the CPU, share of edges equal to the card's {json.dumps(edges_equal)} "
        f"(the CPU took the card's {list(card_graphs) + list(card_derived) + list(card_tensors)}){replayed} [{card}]"
    )
    if not math.isfinite(loss_gpu) or rel > LOSS_RTOL:
        raise AssertionError(f"batch loss on the card {loss_gpu} differs from the CPU's {loss_cpu}")
    bad = [n for n, v in worst.items() if not v <= 1.0]
    if bad:
        raise AssertionError(f"rec gradients on the card differ from the CPU's: {bad}")
    bad = [n for n, v in worst_step.items() if not v <= 1.0]
    if bad:
        raise AssertionError(f"parameters after the step on the card differ from the CPU's: {bad}")
    if flips["worst_flip"] > FLIP_RTOL or flips["flipped"] > FLIP_SHARE * max(flips["entries"], 1):
        raise AssertionError(f"leaky_relu entries on other sides of 0 past rounding on the two devices: {flips}")
    if replay_topk and (not topk_rows["rows"] or topk_rows["differ"] > TOPK_ROW_SHARE * topk_rows["rows"]):
        raise AssertionError(f"the loss's top-k on the two devices: {topk_rows}")
    return dict(loss_rel_err=rel, grad_bound_share=max(worst.values()), cpu_graph_edges_equal=edges_equal, **flips,
                topk_rows=topk_rows, step_bound_share=max(worst_step.values(), default=None))


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


def generate_once():
    """Make ``RecDataset``'s synthetic generator run once for each tier's
    sizes in this process: its table and labels are kept, and every later
    ``RecDataset`` of the same name and sizes takes copies of them. The
    generator is deterministic, so the copies are its tables; its per-user
    loop takes seconds at baby, and the paths build baby's data set some
    sixty times. Returns the kept tables by (name, users, items,
    interactions)."""
    from genmmrec_tpu_torch.data.dataset import InterTable, RecDataset

    generate, kept = RecDataset._generate_synthetic, {}

    def once(self):
        key = (self.dataset_name, *(self.config[f"synthetic_n_{k}"] for k in ("users", "items", "inters")))
        if key not in kept:
            generate(self)
            kept[key] = (self.table, self.labels)
        t, labels = kept[key]
        self.table = InterTable(t.users.copy(), t.items.copy(), t.n_users, t.n_items, times=t.times.copy())
        self.labels = labels.copy()

    RecDataset._generate_synthetic = once
    return kept


def elec_data(torch, dev, dataset="elec", overrides=None):
    """One data set of a tier's sizes for the elec phases: ``synthetic_tables``
    (drawn in bulk), the train and eval data on ``dev``, the group masks,
    and a dict that the trainers share as their packed-mask cache."""
    from types import SimpleNamespace

    from genmmrec_tpu_torch.config import Config
    from genmmrec_tpu_torch.data.arrays import build_eval_data, build_train_data
    from genmmrec_tpu_torch.data.dataset import RecDataset
    from genmmrec_tpu_torch.engine.evaluator import group_masks

    t0 = time.perf_counter()
    over = {"save_recommended_topk": False, **(overrides or {})}
    config = Config("DiffMM", dataset, over)
    train_ds, valid_ds, test_ds = (RecDataset(config, t) for t in synthetic_tables(config, SEED))
    eval_bs = int(config["eval_batch_size"])
    td = build_train_data(train_ds, dev)
    vd = build_eval_data(valid_ds, train_ds, eval_bs, dev)
    ted = build_eval_data(test_ds, train_ds, eval_bs, dev)
    return SimpleNamespace(
        dataset=dataset, overrides=over, config=config, train_ds=train_ds, valid_ds=valid_ds, test_ds=test_ds, td=td, vd=vd,
        ted=ted, pop_warm=group_masks(train_ds, dev), masks={}, data_s=time.perf_counter() - t0,
    )


def graph_cf_setup(torch, dev, model_name="LightGCN", dataset="elec", overrides=None, data=None):
    """A graph-CF model at a dataset tier's full width: synthetic tables of
    the tier's sizes (or ``data``, an ``elec_data`` of the same tier, whose
    packed masks the trainer shares), ``get_model``, parameters from the
    seeded generator, the trainer with its batch plan, and the valid split's
    packed mask. ``overrides`` change the config, for a dry run of the
    control flow at small sizes; on a CPU device such a run skips the launch
    checks."""
    from types import SimpleNamespace

    from genmmrec_tpu_torch import native
    from genmmrec_tpu_torch.config import Config
    from genmmrec_tpu_torch.data.arrays import build_eval_data, build_train_data
    from genmmrec_tpu_torch.data.dataset import RecDataset
    from genmmrec_tpu_torch.engine.trainer import Trainer
    from genmmrec_tpu_torch.models import get_model

    t0 = time.perf_counter()
    over = {"save_recommended_topk": False, "n_layers": 2, **(overrides or {})}
    config = Config(model_name, dataset, over)
    eval_bs = int(config["eval_batch_size"])
    if data is None:
        train_ds, valid_ds, _ = (RecDataset(config, t) for t in synthetic_tables(config, SEED))
        td = build_train_data(train_ds, dev)
        vd = build_eval_data(valid_ds, train_ds, eval_bs, dev)
    else:
        train_ds, td, vd = data.train_ds, data.td, data.vd
    model = get_model(model_name)(config, td)
    model.init_params(torch.Generator(device=dev).manual_seed(SEED))
    trainer = Trainer(config, model)
    if data is not None:
        trainer._mask_cache = data.masks
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
    from genmmrec_tpu_torch import native
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


K1_BOTH = ("segment_spmm", "segment_spmm_backward")
# the CLI phase's runs of ``quick_start``: (key, model, config overrides,
# keyword arguments, kernels the run must launch), each at its published
# width on Amazon-baby
CLI_RUNS = (
    ("FREEDOM", "FREEDOM", {}, dict(max_epochs=2), ("grouped_topk",) + K1_BOTH),
    ("BM3", "BM3", {}, dict(max_epochs=1), ("grouped_topk",) + K1_BOTH),
    ("VBPR", "VBPR", {}, dict(max_epochs=1, mg=True), ("grouped_topk",)),
    ("ItemKNNCBF", "ItemKNNCBF", {}, dict(), ("grouped_topk",)),
)
# run in a child process: ``python -m genmmrec_tpu_torch`` as ``-m`` runs it
# (``runpy`` with the arguments), then the kernels' launch counts on a line
# of their own
CLI_CHILD = (
    "import json, runpy, sys\n"
    "sys.argv = ['genmmrec_tpu_torch'] + sys.argv[1:]\n"
    "runpy.run_module('genmmrec_tpu_torch', run_name='__main__', alter_sys=True)\n"
    "from chip_smoke import launch_counts\n"
    "import torch\n"
    "print('cli launches ' + json.dumps(dict(launch_counts(), device=torch.cuda.get_device_name(0))), flush=True)\n"
)


def quick_start_runs(torch, runs, card, label, after=None, last=None):
    """``quick_start`` of each (key, model, overrides, keyword arguments,
    kernels) of ``runs`` on Amazon-baby on the card, in a temporary working
    directory (``log/``, ``saved/`` and ``recommend_topk/`` land there).
    Each model's set-up, epochs and evaluations are timed by wrapping what
    ``quick_start`` calls. Checks of each run: finite losses and metrics, a
    CSV of every user's top-50 for each test evaluation, no train positive
    in any top-50, each of its kernels launched. ``after(key, run, out)``
    checks more on the run's last combination (its ``model``, ``trainer``,
    ``test_data`` and ``initial``, the parameters of the model's own
    optimizer groups as ``fit`` initialized them) while it is alive; ``last(launches, out)`` runs in
    the directory after the runs. Returns (summary by key, launches by
    key)."""
    import gc
    import itertools
    import logging
    import tempfile

    from genmmrec_tpu_torch import quick_start as qs
    from genmmrec_tpu_torch.engine import evaluator as ev

    out, launches, made = {}, {}, []

    def timed_model(name):
        cls = qs_get_model(name)

        def build(config, data):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model = cls(config, data)
            torch.cuda.synchronize()
            made.append(dict(model=model, setup_s=time.perf_counter() - t0, valid_s=[], test_s=[], test_data=None))
            return model

        return build

    def timed_trainer(name):
        cls = qs_get_trainer(name)

        def build(config, model, mg=False, mesh=None):
            trainer = cls(config, model, mg, mesh)
            run, evaluate = made[-1], trainer.evaluate

            def timed_evaluate(eval_data, is_test=False, idx=0):
                t0 = time.perf_counter()
                res = evaluate(eval_data, is_test, idx)
                run["test_s" if is_test else "valid_s"].append(time.perf_counter() - t0)
                if is_test:
                    run["test_data"] = eval_data
                return res

            trainer.evaluate = timed_evaluate
            run["trainer"] = trainer
            build_step = trainer._build_train_step

            def snapshot_then_build(train_data):
                # the groups of the model's own optimizers as ``fit``
                # initialized them, for a check that the epoch moved them
                run["initial"] = {n: p.detach().clone() for label in model.label_transforms()
                                  for n, p in model.named_parameters() if n.split(".")[0] == label}
                build_step(train_data)

            trainer._build_train_step = snapshot_then_build
            return trainer

        return build

    qs_get_model, qs_get_trainer, local_time = qs.get_model, qs.get_trainer, ev.get_local_time
    stamps = itertools.count()
    root = logging.getLogger()
    handlers = list(root.handlers)
    home = os.getcwd()
    n_tests = 0
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        qs.get_model, qs.get_trainer = timed_model, timed_trainer
        # one CSV name for each test evaluation (a name's time stamp has a
        # resolution of a second)
        ev.get_local_time = lambda: f"n{next(stamps)}"
        try:
            for key, name, overrides, kwargs, need in runs:
                first = len(made)
                reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                combo, valid, test = qs.quick_start(name, "baby", dict(overrides), device="cuda", **kwargs)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launches[key] = launch_counts()
                runs_made = made[first:]
                csvs = sorted(os.listdir("recommend_topk"))
                n_tests += sum(len(r["test_s"]) for r in runs_made)
                if len(csvs) != n_tests:
                    raise AssertionError(f"{key}: {len(csvs)} CSVs for {n_tests} test evaluations")
                for r in runs_made:
                    tr, ted = r["trainer"], r["test_data"]
                    losses = list(tr.train_loss_dict.values())
                    if not losses or not all(math.isfinite(v) for v in losses):
                        raise AssertionError(f"{key}: a training loss is not finite: {losses}")
                    top = tr.eval_topk(ted)
                    if top.min().item() < 0:
                        raise AssertionError(f"{key}: a pad entry is in a top-50")
                    mask = tr._dense_mask(ted)
                    listed = (mask.gather(1, top >> 3) >> (top & 7).to(torch.uint8)) & 1
                    if listed[ted.valid].any():
                        raise AssertionError(f"{key}: a train positive is in a top-50")
                for res in (valid, test):
                    bad = [k for k, v in res.items() if not math.isfinite(v)]
                    if bad or "recall@20" not in res:
                        raise AssertionError(f"{key}: non-finite or missing metrics {bad}")
                if any(launches[key][k] <= 0 for k in need):
                    raise AssertionError(f"{key}: one of {need} not launched: {launches[key]}")
                with open(os.path.join("recommend_topk", csvs[-1])) as f:
                    rows = [ln.split("\t") for ln in f.read().splitlines()]
                ted = runs_made[-1]["test_data"]
                if len(rows) != ted.n_users_eval + 1 or any(len(r) != 51 for r in rows) or rows[0][:2] != ["id", "top_0"]:
                    raise AssertionError(f"{key}: the last CSV is not a header and one top-50 row a test user")
                out[key] = dict(
                    wall_s=wall, combos=len(runs_made), best_combo=list(combo),
                    setup_s=[r["setup_s"] for r in runs_made],
                    epoch_s=[list(r["trainer"].epoch_times) for r in runs_made],
                    valid_s=[r["valid_s"] for r in runs_made], test_s=[r["test_s"] for r in runs_made],
                    valid_recall20=valid["recall@20"], test_recall20=test["recall@20"], csvs=len(csvs),
                    train_batches=runs_made[-1]["trainer"]._num_batches * len(runs_made[-1]["trainer"].epoch_times),
                )
                o = out[key]
                print(
                    f"{label} quick_start({name}, baby, {overrides}, {kwargs}): {o['combos']} combination(s), best "
                    f"{combo}, {wall:.2f} s in all; set-up {json.dumps([round(v, 3) for v in o['setup_s']])} s, epochs "
                    f"{json.dumps([[round(v, 3) for v in e] for e in o['epoch_s']])} s, evaluate(valid) "
                    f"{json.dumps([[round(v, 3) for v in e] for e in o['valid_s']])} s, evaluate(test) "
                    f"{json.dumps([[round(v, 3) for v in e] for e in o['test_s']])} s; Recall@20 valid "
                    f"{valid['recall@20']:.4f} test {test['recall@20']:.4f}; launches {json.dumps(launches[key])} [{card}]"
                )
                if after is not None:
                    after(key, runs_made[-1], o)
                runs_made = tr = ted = None
                made.clear()
                # a trainer and its timed evaluate hold each other
                gc.collect()
                torch.cuda.empty_cache()
            if last is not None:
                last(launches, out)
        finally:
            qs.get_model, qs.get_trainer, ev.get_local_time = qs_get_model, qs_get_trainer, local_time
            os.chdir(home)
            for h in list(root.handlers):
                root.removeHandler(h)
                if h not in handlers:
                    h.close()
            for h in handlers:
                root.addHandler(h)
    return out, launches


def cli_path(torch, card):
    """The CLI: ``quick_start`` for each of ``CLI_RUNS`` (``quick_start_runs``),
    then ``python -m genmmrec_tpu_torch --model FREEDOM --dataset baby
    --epochs 1`` with bfloat16 evaluation in a child process that names no
    device. Checks beside the runs': K5a and K5b launched in the child,
    FREEDOM's batch on the card against the CPU, ItemKNNCBF's similarity
    top-k (K3) against its plain version on one block, and FREEDOM's graphs
    under K1 against their plain versions. Returns (summary, kernel cases by
    kernel, launches)."""
    from genmmrec_tpu_torch.data.dataset import RecDataset

    cases = dict(k1=[], k1_bwd=[], k3=[])
    checkout = os.path.dirname(os.path.abspath(__file__))

    def after(key, r, o):
        tr, model = r["trainer"], r["model"]
        if key == "FREEDOM":
            pruned = model.ui.graph(tr.state["masked_vals"])
            cases["k1"] += check_spmm(
                torch, [("freedom_item_graph_d64", model.mm_adj, model.embedding_dim),
                        ("freedom_pruned_ui_d64", pruned, model.embedding_dim)], card,
            )["cases"]
            cases["k1_bwd"].append(
                check_nonsymmetric_grad(torch, model.mm_adj, model.embedding_dim, card, case="freedom_item_graph")
            )
            cases["k1_bwd"] += check_spmm_backward(
                torch, [("freedom_pruned_ui_d64", pruned, model.embedding_dim)], card
            )["cases"]
            train_ds = RecDataset(tr.config).split()[0]
            biases = {f"{m}_trs.bias": f"{m}_trs.weight" for m in ("image", "text")}
            o["batch_vs_cpu"] = check_batch_against_cpu(
                torch, tr, model.data, train_ds, tr.config, card, zero_grads=biases, card_graphs=("mm_adj",),
            )
        if key == "ItemKNNCBF":
            cases["k3"] += check_k3(
                torch, [("itemknncbf_similarity_top10", model.similarity(0, 4096), model.knn_k, None)], card
            )["cases"]

    def child(launches, out):
        # the command line in a child process, on the default device
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [checkout, os.environ.get("PYTHONPATH")])))
        args = ["--model", "FREEDOM", "--dataset", "baby", "--epochs", "1", "--config-json",
                json.dumps({"eval_dtype": "bfloat16"})]
        before = set(os.listdir("recommend_topk"))
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-c", CLI_CHILD, *args], capture_output=True, text=True,
                             env=env, timeout=600)
        child_s = time.perf_counter() - t0
        counts = [ln for ln in run.stdout.splitlines() if ln.startswith("cli launches ")]
        if run.returncode != 0 or not counts:
            raise AssertionError(f"python -m genmmrec_tpu_torch failed (rc {run.returncode}):\n{run.stderr[-4000:]}")
        counts = json.loads(counts[-1][len("cli launches "):])
        best = "█████████████ BEST ████████████████" in run.stderr
        child_csvs = sorted(set(os.listdir("recommend_topk")) - before)
        need = [k for k in ("segment_spmm", "segment_spmm_backward", "grouped_topk", "fused_group_max",
                            "fused_candidates") if counts[k] <= 0]
        if need or not best or not child_csvs:
            raise AssertionError(f"python -m genmmrec_tpu_torch: launches {counts}, BEST block {best}, CSVs {child_csvs}")
        epoch_lines = [ln.split("INFO ", 1)[-1] for ln in run.stderr.splitlines() if "training [time:" in ln
                       or "evaluating [time:" in ln]
        launches["cli_child"] = {k: counts[k] for k in launch_counts()}
        out["cli_child"] = dict(rc=run.returncode, wall_s=child_s, device=counts["device"], log=epoch_lines)
        print(
            f"CLI python -m genmmrec_tpu_torch {' '.join(args)} (no --device): rc {run.returncode} in "
            f"{child_s:.1f} s on {counts['device']}, BEST block printed, CSV {child_csvs[-1]}; "
            f"{'; '.join(epoch_lines)}; launches {json.dumps(launches['cli_child'])} [{card}]"
        )

    phase_t0 = time.perf_counter()
    out, launches = quick_start_runs(torch, CLI_RUNS, card, "CLI", after, child)
    total = {k: sum(l[k] for l in launches.values()) for k in launch_counts()}
    for kname in ("segment_spmm", "segment_spmm_backward", "grouped_topk"):
        if total[kname] <= 0:
            raise AssertionError(f"CLI phase: {kname} never launched")
    out["phase_s"] = time.perf_counter() - phase_t0
    print(f"CLI phase done in {out['phase_s']:.1f} s; launches {json.dumps(launches)}")
    return dict(**out, launches=launches), cases, total


# the message-passing phase's runs of ``quick_start``, each model at its
# published widths on Amazon-baby for one epoch; a hyper-parameter list of
# the YAML is set to one of its values, so that the grid is one combination
MP_NEED = ("grouped_topk",) + K1_BOTH
MP_RUNS = (
    ("MMGCN", "MMGCN", {"reg_weight": 0.0001}, dict(max_epochs=1), MP_NEED),
    ("GRCN", "GRCN", {"reg_weight": 0.001}, dict(max_epochs=1), MP_NEED),
    ("DualGNN", "DualGNN", {}, dict(max_epochs=1), MP_NEED),
    ("DualGNN_bf16", "DualGNN", {"eval_dtype": "bfloat16"}, dict(max_epochs=1),
     MP_NEED + ("fused_group_max", "fused_candidates")),
    ("DRAGON", "DRAGON", {"learning_rate": 0.001, "reg_weight": 0.001}, dict(max_epochs=1), MP_NEED),
    ("COHESION", "COHESION", {}, dict(max_epochs=1), MP_NEED),
    ("MVGAE", "MVGAE", {"beta": 0.1}, dict(max_epochs=1), MP_NEED),
)
# the users of the user graph built on both devices for its check
USER_GRAPH_CHECK_USERS = 4096


def propagate_plain(torch, g, x, aggr, w=None):
    """``propagate``'s plain version: the scatter of the weighted messages
    (``index_add_``) and, for ``mean``, the division by the clamped in-degree."""
    w = g.vals if w is None else w
    out = torch.zeros(g.n_rows, x.shape[1], device=x.device).index_add_(0, g.rows.long(), w[:, None] * x[g.cols.long()])
    if aggr == "mean":
        out = out / (g.row_ptr[1:] - g.row_ptr[:-1]).float().clamp(min=1.0)[:, None]
    return out


def check_propagate(torch, cases_in, card):
    """K1 through ``ops/mp.py`` ``propagate`` against its plain version on
    each (name, graph, aggr, d): the forward within K1_RTOL · Σ|terms| (over
    the degree for ``mean``) + K1_ATOL, and the x-gradient through autograd
    (K1 on the cotangent over the graph's own edges or its transposed CSR)
    within the same bound over Aᵀ; both bit-equal on a second run. Timed:
    the forward (also K1's launch alone, and the forward's device time from
    a CUDA graph), and forward+backward through autograd, against the plain
    version and the library (``torch.sparse.mm``, then the division for
    ``mean``; two products for forward+backward). Returns (forward cases,
    backward cases)."""
    from genmmrec_tpu_torch.ops.mp import propagate
    from genmmrec_tpu_torch.ops.segment import segment_spmm

    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    fwd_cases, bwd_cases = [], []
    for name, g, aggr, d in cases_in:
        deg = (g.row_ptr[1:] - g.row_ptr[:-1]).float().clamp(min=1.0) if aggr == "mean" else None
        scale = (lambda y: y / deg[:, None]) if aggr == "mean" else (lambda y: y)
        t = g if g.symmetric else g.transposed()
        x = torch.randn(g.n_cols, d, generator=gen, device="cuda")
        g_bar = torch.randn(g.n_rows, d, generator=gen, device="cuda")
        abs_g = dataclasses.replace(g, vals=g.vals.abs())
        out = propagate(x, g, aggr)
        diff = (out - propagate_plain(torch, g, x, aggr)).abs()
        magnitude = propagate_plain(torch, abs_g, x.abs(), aggr)
        e = diff.max().item()
        if not bool((diff <= K1_RTOL * magnitude + K1_ATOL).all()):
            raise AssertionError(f"K1 propagate {name}: kernel and plain version differ by up to {e:.3e}")
        if not torch.equal(propagate(x, g, aggr), out):
            raise AssertionError(f"K1 propagate {name}: two launches differ")
        k_ms, p_ms = timed_pair(torch, lambda: propagate(x, g, aggr), lambda: propagate_plain(torch, g, x, aggr))
        # K1's launch alone, and propagate's device time with the host out of the way
        launch_ms = cuda_ms(torch, lambda: segment_spmm(g.row_ptr, g.cols, g.vals, x, g.n_rows, g.long_rows))
        device_ms = graph_ms(torch, lambda: propagate(x, g, aggr))
        csr = torch.sparse_csr_tensor(g.row_ptr, g.cols, g.vals, size=(g.n_rows, g.n_cols), check_invariants=False)
        csr_t = torch.sparse_csr_tensor(t.row_ptr, t.cols, t.vals, size=(t.n_rows, t.n_cols), check_invariants=False)
        l_ms = cuda_ms(torch, lambda: scale(torch.sparse.mm(csr, x)))
        b = Bound().add(nbytes(g.row_ptr, g.cols, g.vals, x, out), 2.0 * g.nnz * d, F32_FLOPS)
        with torch.enable_grad():
            xg = x.clone().requires_grad_()
            grad = lambda fwd: torch.autograd.grad(fwd(xg), xg, g_bar)[0]
            kernel_fb = lambda: grad(lambda v: propagate(v, g, aggr))
            plain_fb = lambda: grad(lambda v: propagate_plain(torch, g, v, aggr))
            got, ref = kernel_fb(), plain_fb()
            diff_b = (got - ref).abs()
            magnitude_b = propagate_plain(torch, dataclasses.replace(t, vals=t.vals.abs()), scale(g_bar).abs(), "add")
            eb = diff_b.max().item()
            if not bool((diff_b <= K1_RTOL * magnitude_b + K1_ATOL).all()):
                raise AssertionError(f"K1 backward propagate {name}: x-gradients differ by up to {eb:.3e}")
            if not torch.equal(kernel_fb(), got):
                raise AssertionError(f"K1 backward propagate {name}: two backward runs differ")
            kb_ms, pb_ms = timed_pair(torch, kernel_fb, plain_fb)
        lb_ms = cuda_ms(torch, lambda: (scale(torch.sparse.mm(csr, x)), torch.sparse.mm(csr_t, scale(g_bar))))
        bb = Bound().add(2 * nbytes(g.row_ptr, g.cols, g.vals, x, g_bar), 4.0 * g.nnz * d, F32_FLOPS)
        longest = int((g.row_ptr[1:] - g.row_ptr[:-1]).max())
        route = "the same edges" if g.symmetric else "the transposed CSR"
        print(
            f"K1 propagate {name} ({aggr}, {g.n_rows} rows, nnz={g.nnz}, longest row {longest}, d={d}): forward "
            f"max_abs_err={e:.3e} repeatable, kernel {k_ms:.4f} ms (K1's launch alone {launch_ms:.4f} ms; device time "
            f"from a CUDA graph {device_ms:.4f} ms), plain {p_ms:.4f} ms, torch.sparse.mm {l_ms:.4f} "
            f"ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}); x-gradient over {route} max_abs_err={eb:.3e} "
            f"repeatable, forward+backward kernel {kb_ms:.4f} ms, plain {pb_ms:.4f} ms, two torch.sparse.mm "
            f"{lb_ms:.4f} ms, bound {bb['bound_ms']:.4f} ms [{card}]"
        )
        common = dict(n_rows=g.n_rows, nnz=g.nnz, longest_row=longest, d=d, aggr=aggr)
        fwd_cases.append(dict(case=f"propagate_{name}", max_abs_err=e, ms=k_ms, launch_ms=launch_ms,
                              graph_ms=device_ms, plain_ms=p_ms, library_ms=l_ms, **common, **b))
        bwd_cases.append(dict(case=f"propagate_{name}", max_abs_err=eb, ms=kb_ms, plain_ms=pb_ms, library_ms=lb_ms,
                              backward_route=route, **common, **bb))
    return fwd_cases, bwd_cases


def check_edge_weight_grad(torch, g, d, card, name):
    """``propagate(x, g, "add", w)`` with an edge weight that requires a
    gradient (GRCN's): the x-gradient (K1 over the transposed CSR) and the
    edge-weight gradient (``_Spmm``'s plain ``Σ_d x[src]·ḡ[dst]``) on the
    card against the same on the CPU, each element within K1_RTOL of the
    sum of its terms' magnitudes + K1_ATOL; timed forward+backward against
    the plain version's autograd on the card."""
    from genmmrec_tpu_torch.ops.mp import propagate

    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    x = torch.randn(g.n_cols, d, generator=gen, device="cuda")
    w = torch.rand(g.nnz, generator=gen, device="cuda")
    g_bar = torch.randn(g.n_rows, d, generator=gen, device="cuda")

    def grads(graph, fwd, *args):
        with torch.enable_grad():
            xs, ws = (a.clone().requires_grad_() for a in args[:2])
            return torch.autograd.grad(fwd(graph, xs, ws), (xs, ws), args[2])

    kernel = lambda graph, xs, ws: propagate(xs, graph, "add", ws)
    plain = lambda graph, xs, ws: propagate_plain(torch, graph, xs, "add", ws)
    on_card = grads(g, kernel, x, w, g_bar)
    cpu = torch.device("cpu")
    on_cpu = grads(g.to(cpu), kernel, x.cpu(), w.cpu(), g_bar.cpu())
    t = g.transposed(w)
    mag_x = propagate_plain(torch, dataclasses.replace(t, vals=t.vals.abs()), g_bar.abs(), "add")
    mag_w = (x[g.cols.long()].abs() * g_bar[g.rows.long()].abs()).sum(-1)
    errs = {}
    for part, got, ref, mag in (("x", on_card[0], on_cpu[0], mag_x), ("edge_weight", on_card[1], on_cpu[1], mag_w)):
        diff = (got.cpu() - ref).abs()
        errs[part] = diff.max().item()
        if not bool((diff <= K1_RTOL * mag.cpu() + K1_ATOL).all()):
            raise AssertionError(f"{name}: the {part} gradient on the card differs from the CPU's by up to {errs[part]:.3e}")
    ms, plain_ms = timed_pair(torch, lambda: grads(g, kernel, x, w, g_bar), lambda: grads(g, plain, x, w, g_bar))
    # the library's way: a COO tensor over the weights (its values carry the
    # gradient), torch.sparse.mm forward and backward into x and the weights
    index = torch.stack([g.rows.long(), g.cols.long()])
    coo = lambda graph, xs, ws: torch.sparse.mm(
        torch.sparse_coo_tensor(index, ws, (graph.n_rows, graph.n_cols), check_invariants=False), xs
    )
    lib_ms = cuda_ms(torch, lambda: grads(g, coo, x, w, g_bar))
    # the edges, weights, x and the cotangent read once; the product and the
    # two gradients written once
    moved = nbytes(g.row_ptr, g.rows, g.cols, w, x, g_bar) + nbytes(g_bar, x, w)
    b = Bound().add(moved, 6.0 * g.nnz * d, F32_FLOPS)
    print(
        f"K1 backward {name} (edge weights with a gradient, {g.n_rows} rows, nnz={g.nnz}, d={d}): x-gradient over the "
        f"transposed CSR and the edge-weight gradient on the card against the CPU, max_abs_err x {errs['x']:.3e}, "
        f"edge weight {errs['edge_weight']:.3e}; forward+backward kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"torch.sparse.mm (COO, values with a gradient) {lib_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
        f"({b['bound_by']}) [{card}]"
    )
    return dict(case=name, d=d, max_abs_err_x=errs["x"], max_abs_err_edge_weight=errs["edge_weight"], ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, **b)


def _sorted_and_strict(np, nbrs, w):
    """Each row's weights sorted descending, and each row's set of
    neighbours whose weight is above the row's least."""
    return -np.sort(-w, axis=1), [frozenset(n[x > x.min()].tolist()) for n, x in zip(nbrs, w)]


def check_user_graph(torch, model, train_ds, card):
    """DualGNN's user co-occurrence graph. ``build_user_graph`` on the card
    and on the CPU for the first USER_GRAPH_CHECK_USERS users'
    pairs: each row's sorted weights within 1e-6 and the neighbours above
    the row's least weight equal (counts tie, so the ids of tied neighbours
    may differ). The model's full graph against a host reference from
    scipy's sparse ``R @ Rᵀ``: the same two. K3 on one block of counts
    against its plain version."""
    import numpy as np
    import scipy.sparse as sp

    from genmmrec_tpu_torch.models.dualgnn import build_user_graph
    from genmmrec_tpu_torch.ops.graph import USER_GRAPH_BLOCK, unique_ui_pairs

    users, items = unique_ui_pairs(train_ds.table.users, train_ds.table.items)
    k, n_items = model.k, model.n_items
    as_rows = lambda g: (g.cols.cpu().numpy().reshape(-1, k), g.vals.cpu().numpy().reshape(-1, k))
    sel = users < USER_GRAPH_CHECK_USERS
    sub = [as_rows(build_user_graph(model.config, users[sel], items[sel], USER_GRAPH_CHECK_USERS, n_items, k, dev))
           for dev in ("cuda", "cpu")]
    (card_w, card_s), (cpu_w, cpu_s) = (_sorted_and_strict(np, *r) for r in sub)
    sub_err = float(np.abs(card_w - cpu_w).max())
    if sub_err > 1e-6 or card_s != cpu_s:
        raise AssertionError(f"user graph: the card's build differs from the CPU's ({sub_err:.3e})")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full = build_user_graph(model.config, users, items, model.n_users, n_items, k, "cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if not all(torch.equal(getattr(full, f), getattr(model.user_graph, f)) for f in ("rows", "cols", "vals")):
        raise AssertionError("user graph: a second build on the card differs from the model's")
    r = sp.csr_matrix((np.ones(len(users), np.float32), (users, items)), shape=(model.n_users, n_items))
    co = (r @ r.T).tocsr()
    co.setdiag(0)  # every user's diagonal entry exists: no change of structure
    co.eliminate_zeros()
    ref_w = np.zeros((model.n_users, k))
    ref_s = []
    for u in range(model.n_users):
        cnt, nb = co.data[co.indptr[u] : co.indptr[u + 1]], co.indices[co.indptr[u] : co.indptr[u + 1]]
        top = -np.sort(-cnt)[:k]
        if len(top):
            e = np.exp(top - top[0])
            ref_w[u, : len(top)] = e / e.sum()
        cut = top[k - 1] if len(top) >= k else 0
        ref_s.append(frozenset(nb[cnt > cut].tolist()))
    got_w, got_s = _sorted_and_strict(np, *as_rows(model.user_graph))
    full_err = float(np.abs(got_w - ref_w).max())
    if full_err > 1e-6 or got_s != ref_s:
        raise AssertionError(f"user graph: the card's graph differs from scipy's counts ({full_err:.3e}, "
                             f"{sum(a != b for a, b in zip(got_s, ref_s))} rows' strict sets)")
    n_full = int((ref_w > 0).all(1).sum())
    tied = int(sum((w == w.min()).sum() > 1 for w in got_w[(ref_w > 0).all(1)]))
    print(
        f"user graph (DualGNN/baby, {model.n_users} users, top-{k}): built on the card in {build_s:.3f} s (R @ Rᵀ in "
        f"blocks of {USER_GRAPH_BLOCK}, K3), equal to a second build; against the CPU's build on {USER_GRAPH_CHECK_USERS} "
        f"users sorted weights within {sub_err:.1e}, strict sets equal; against scipy's counts sorted weights within "
        f"{full_err:.1e}, strict sets equal ({n_full} rows of {k} neighbours, {tied} of them tied at the least) [{card}]"
    )
    rt = torch.zeros(model.n_users, n_items, device="cuda")
    rt[torch.as_tensor(users, device="cuda"), torch.as_tensor(items, device="cuda")] = 1.0
    block = rt[:USER_GRAPH_BLOCK] @ rt.T
    block[torch.arange(USER_GRAPH_BLOCK, device="cuda"), torch.arange(USER_GRAPH_BLOCK, device="cuda")] = 0.0
    k3 = check_k3(torch, [("dualgnn_cooccurrence_top40", block, k, None)], card)["cases"]
    return dict(build_s=build_s, subset_max_abs_err=sub_err, full_max_abs_err=full_err, full_rows=n_full,
                tied_rows=tied), k3


def mp_path(torch, card, profile_dir=None):
    """The message-passing models: ``quick_start`` for each of ``MP_RUNS``
    (``quick_start_runs``: one epoch, ``evaluate`` valid and test; DualGNN
    once more with bfloat16 evaluation, K5a and K5b). Checks beside the
    runs': K1 through ``propagate`` against its plain version on MMGCN's
    dst-sorted user-item graph (``mean``) at d = 64, 256 and 384 and on
    MVGAE's self-looped one at d = 64, forward and backward; GRCN's
    edge-weight gradient on the card against the CPU; one batch's loss and
    every gradient on the card against the CPU for GRCN and for MVGAE (its
    draws made on the card and handed to both); DualGNN's user graph
    (``check_user_graph``). ``profile_dir`` adds ten more training batches
    of each model under ``torch.profiler``. Returns (summary, kernel cases by
    kernel, launches)."""
    from genmmrec_tpu_torch.data.dataset import RecDataset

    cases = dict(k1=[], k1_bwd=[], k3=[])
    data = {}

    def train_ds(config):
        # the baby data of every run: generated once for the checks
        if "train" not in data:
            data["train"] = RecDataset(config).split()[0]
        return data["train"]

    def after(key, r, o):
        tr, model = r["trainer"], r["model"]
        if key in ("MMGCN", "MVGAE"):
            widths = (model.dim_x,) + ((model.dim_latent_v, model.t_feat.shape[1]) if key == "MMGCN" else ())
            f, b = check_propagate(torch, [(f"{key.lower()}_ui_mean_d{d}", model.graph, "mean", d) for d in widths], card)
            cases["k1"] += f
            cases["k1_bwd"] += b
        if key == "GRCN":
            cases["k1_bwd"].append(check_edge_weight_grad(torch, model.graph, model.dim_x, card, "grcn_edge_weights_d64"))
            o["batch_vs_cpu"] = check_batch_against_cpu(
                torch, tr, model.data, train_ds(tr.config), tr.config, card, replay_branches=True
            )
        if key == "MVGAE":
            keep, noise = model.draws(torch.Generator(device="cuda").manual_seed(SEED + 11))
            o["batch_vs_cpu"] = check_batch_against_cpu(
                torch, tr, model.data, train_ds(tr.config), tr.config, card,
                loss_kwargs=dict(keep=keep, noise=noise), replay_branches=True,
            )
        if key == "DualGNN":
            o["user_graph"], k3 = check_user_graph(torch, model, train_ds(tr.config), card)
            cases["k3"] += k3
        if profile_dir:
            from torch.profiler import ProfilerActivity, profile

            gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
            B = tr.train_batch_size
            idx = torch.randperm(tr._num_batches * B, generator=gen, device="cuda")[: 10 * B].reshape(10, B)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                tr._train_epoch(gen, plan={"idx": idx})
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            write_profile(torch, prof, profile_dir, f"{key}_baby_train_10_batches", wall, card)

    phase_t0 = time.perf_counter()
    out, launches = quick_start_runs(torch, MP_RUNS, card, "mp_path", after)
    total = {k: sum(l[k] for l in launches.values()) for k in launch_counts()}
    out["phase_s"] = time.perf_counter() - phase_t0
    print(f"mp_path phase done in {out['phase_s']:.1f} s; launches {json.dumps(launches)}")
    return dict(**out, launches=launches), cases, total


# the last multimodal graph models' runs of ``quick_start``, each at its
# published widths on Amazon-baby for one epoch (every YAML list of these
# is one value); MGCN once more in bfloat16, which takes the fused route
MMG_RUNS = (
    ("GUME", "GUME", {}, dict(max_epochs=1), MP_NEED),
    ("LATTICE", "LATTICE", {}, dict(max_epochs=1), MP_NEED),
    ("MGCN", "MGCN", {}, dict(max_epochs=1), MP_NEED),
    ("MGCN_bf16", "MGCN", {"eval_dtype": "bfloat16"}, dict(max_epochs=1),
     MP_NEED + ("fused_group_max", "fused_candidates")),
    ("LGMRec", "LGMRec", {}, dict(max_epochs=1), MP_NEED),
    ("SMORE", "SMORE", {}, dict(max_epochs=1), MP_NEED),
    ("PGL", "PGL", {}, dict(max_epochs=1), MP_NEED),
    ("SLMRec", "SLMRec", {}, dict(max_epochs=1), MP_NEED),
    ("DAMRS", "DAMRS", {}, dict(max_epochs=1), MP_NEED),
)
# LATTICE's training batches run again with the counts at 0, to show its
# per-step top-k on K3
LATTICE_CHECK_BATCHES = 3
# the users whose interactions the card and the CPU both count for DAMRS's
# co-occurrence check
COOCCURRENCE_CHECK_USERS = 2048


def check_lattice(torch, tr, model, card):
    """LATTICE's per-step top-k: K3 on the learned similarity plane of the
    image projection (7,050² float32, k = ``knn_k``) against its plain
    version and ``torch.topk``; the learned graph's gradient into the
    projections and ``modal_weight`` on the card against the CPU (the CPU
    takes the card's columns of the top-k; a random cotangent); then
    LATTICE_CHECK_BATCHES training batches with the counts at 0, which must
    launch K3 twice a batch, and the peak memory they hold. Returns (K3
    cases, summary)."""
    from genmmrec_tpu_torch.ops.graph import build_sim, norm_laplacian_dense
    from genmmrec_tpu_torch.ops.topk import grouped_topk

    with torch.no_grad():
        sim = build_sim(model.image_trs(model.v_feat))
    k3 = check_k3(torch, [("lattice_learned_sim_top10", sim, model.knn_k, None)], card)["cases"]
    del sim
    cpu = torch.device("cpu")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    n = model.n_items
    g_bar = torch.randn(n, n, generator=gen, device="cuda")
    names = ("modal_weight", "image_trs.weight", "image_trs.bias", "text_trs.weight", "text_trs.bias")

    def grads(dev, idx=None):
        """The gradients, the columns taken (``idx``, else its own) and its own."""
        params = {k: v.detach().to(dev).requires_grad_() for k, v in model.named_parameters() if k in names}
        weight = torch.softmax(params["modal_weight"], dim=0)
        planes, taken, own = [], [], []
        for m, feats in (("image", model.v_feat), ("text", model.t_feat)):
            s = build_sim(feats.to(dev) @ params[f"{m}_trs.weight"].T + params[f"{m}_trs.bias"])
            own.append(grouped_topk(s.detach(), model.knn_k)[1])
            taken.append(own[-1] if idx is None else idx[len(planes)].to(dev))
            planes.append(torch.zeros_like(s).scatter(1, taken[-1], s.gather(1, taken[-1])))
        adj = norm_laplacian_dense(weight[0] * planes[0] + weight[1] * planes[1], "sym")
        out = torch.autograd.grad((adj * g_bar.to(dev)).sum(), [params[k] for k in names])
        return [o.cpu() for o in out], taken, own

    with torch.enable_grad():
        on_card, picked, _ = grads("cuda")
        on_cpu, _, cpu_own = grads(cpu, picked)
    differ = sum(int((a.cpu().sort(1).values != b.sort(1).values).any(1).sum()) for a, b in zip(picked, cpu_own))
    if differ > TOPK_ROW_SHARE * 2 * n:
        raise AssertionError(f"LATTICE's learned top-k: the CPU's own columns differ on {differ} rows")
    worst = {}
    for name, a, b in zip(names, on_card, on_cpu):
        bound = GRAD_RTOL * b.abs() + GRAD_ATOL * b.abs().max()
        worst[name] = float(((a - b).abs() / bound.clamp(min=1e-30)).max())
    if not all(v <= 1.0 for v in worst.values()):
        raise AssertionError(f"LATTICE's learned graph: gradients on the card differ from the CPU's {worst}")
    # the path's training batches, counted: K3 twice a batch
    B = tr.train_batch_size
    idx = torch.randperm(tr._num_batches * B, generator=gen, device="cuda")[: LATTICE_CHECK_BATCHES * B]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    t0 = time.perf_counter()
    tr._train_epoch(gen, plan={"idx": idx.reshape(LATTICE_CHECK_BATCHES, B)})
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / LATTICE_CHECK_BATCHES * 1e3
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if counts["grouped_topk"] != 2 * LATTICE_CHECK_BATCHES or counts["segment_spmm"] <= 0:
        raise AssertionError(f"LATTICE's training batches: K3 not launched twice a batch: {counts}")
    print(
        f"LATTICE per-step top-k: the learned graph's gradients (modal_weight, the projections; the CPU took the card's "
        f"columns, its own differ on {differ} of {2 * n} rows) on the card against the CPU, largest share of the bound "
        f"{json.dumps({k: round(v, 4) for k, v in worst.items()})}; {LATTICE_CHECK_BATCHES} training batches "
        f"{step_ms:.2f} ms a batch, launches {json.dumps(counts)}; peak memory {peak / 2**30:.3f} GiB "
        f"({(peak - base) / 2**30:.3f} GiB above the {base / 2**30:.3f} GiB held before the batches) [{card}]"
    )
    return k3, dict(grad_bound_share=worst, topk_rows_differ=differ, step_ms=step_ms, launches=counts,
                    peak_gib=peak / 2**30, base_gib=base / 2**30)


def check_smore_fusion(torch, model, card):
    """SMORE's fusion graph built on the CPU from the card's two KNN graphs
    equals the card's, edge for edge and value for value; K3 on the image
    similarity plane at k = ``image_knn_k`` (40) against its plain
    version."""
    from genmmrec_tpu_torch.models.smore import max_pool_fusion

    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    ref = max_pool_fusion(model.image_original_adj.to(cpu), model.text_original_adj.to(cpu))
    cpu_s = time.perf_counter() - t0
    g = model.fusion_adj
    if not all(torch.equal(getattr(g, f).cpu(), getattr(ref, f)) for f in ("rows", "cols", "vals", "row_ptr")):
        raise AssertionError("SMORE's fusion graph differs from the CPU's build")
    both = model.image_original_adj.nnz + model.text_original_adj.nnz - g.nnz
    print(
        f"SMORE fusion graph: nnz {g.nnz} (image {model.image_original_adj.nnz}, text {model.text_original_adj.nnz}, "
        f"{both} pairs in both at the larger value) equal to the CPU's build ({cpu_s:.3f} s on the host) [{card}]"
    )
    f = torch.nn.functional.normalize(model.v_feat, dim=1, eps=1e-12)
    return check_k3(torch, [("smore_image_sim_top40", f @ f.T, model.image_knn_k, None)], card)["cases"], g.nnz


def check_damrs_cooccurrence(torch, model, train_ds, card):
    """DAMRS's co-occurrence neighbours: ``cooccurrence_neighbours`` on the
    card and on the CPU over the first COOCCURRENCE_CHECK_USERS users'
    interactions, each row's sorted counts equal and its neighbours above
    the row's least count equal (counts tie); the model's session graph
    against scipy's sparse ``RᵀR`` over every interaction, the same two; K3
    on one block of counts against its plain version."""
    import numpy as np
    import scipy.sparse as sp

    from genmmrec_tpu_torch.models.damrs import COOCCURRENCE_BLOCK, cooccurrence_neighbours

    users, items = train_ds.table.users, train_ds.table.items
    n, k = model.n_items, min(model.knn_k, model.n_items - 1)
    sel = users < COOCCURRENCE_CHECK_USERS
    sub = [cooccurrence_neighbours(users[sel], items[sel], COOCCURRENCE_CHECK_USERS, n, k, dev) for dev in ("cuda", "cpu")]
    as_np = lambda nb, c: (nb.cpu().numpy(), c.cpu().numpy())
    (card_w, card_s), (cpu_w, cpu_s) = (_sorted_and_strict(np, *as_np(*r)) for r in sub)
    if not (np.array_equal(card_w, cpu_w) and card_s == cpu_s):
        raise AssertionError("DAMRS co-occurrence: the card's build differs from the CPU's")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nbrs, counts = cooccurrence_neighbours(users, items, model.n_users, n, k, "cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    r = sp.csr_matrix((np.ones(len(users), np.float32), (users, items)), shape=(model.n_users, n))
    co = (r.T @ r).tocsr()
    co.setdiag(0)
    co.eliminate_zeros()
    ref_w, ref_s = np.zeros((n, k)), []
    for i in range(n):
        cnt, nb = co.data[co.indptr[i] : co.indptr[i + 1]], co.indices[co.indptr[i] : co.indptr[i + 1]]
        top = -np.sort(-cnt)[:k]
        ref_w[i, : len(top)] = top
        cut = top[k - 1] if len(top) >= k else 0
        ref_s.append(frozenset(nb[cnt > cut].tolist()))
    got_w, got_s = _sorted_and_strict(np, *as_np(nbrs, counts))
    if not (np.array_equal(got_w, ref_w) and got_s == ref_s):
        raise AssertionError("DAMRS co-occurrence: the card's neighbours differ from scipy's counts")
    # the model's session graph holds exactly these neighbours of positive count
    g = model.session_adj
    if g.nnz != n + int((counts > 0).sum()):
        raise AssertionError(f"DAMRS session graph: nnz {g.nnz} for {int((counts > 0).sum())} neighbours and {n} loops")
    tied = int(sum((w == w.min()).sum() > 1 for w in got_w[(ref_w > 0).all(1)]))
    print(
        f"DAMRS co-occurrence ({n} items, top-{k}): built on the card in {build_s:.3f} s (RᵀR in blocks of "
        f"{COOCCURRENCE_BLOCK}, K3), against the CPU's build on {COOCCURRENCE_CHECK_USERS} users and scipy's counts "
        f"on all: sorted counts and strict sets equal ({int((ref_w > 0).all(1).sum())} full rows, {tied} tied at the "
        f"least); session graph nnz {g.nnz} [{card}]"
    )
    rt = torch.zeros(model.n_users, n, device="cuda")
    rt.index_put_((torch.as_tensor(users, device="cuda"), torch.as_tensor(items, device="cuda")),
                  torch.ones(len(users), device="cuda"), accumulate=True)
    block = rt[:, :COOCCURRENCE_BLOCK].T @ rt
    rows = torch.arange(COOCCURRENCE_BLOCK, device="cuda")
    block[rows, rows] = 0.0
    k3 = check_k3(torch, [("damrs_cooccurrence_top10", block, k, None)], card)["cases"]
    return dict(build_s=build_s, full_rows=int((ref_w > 0).all(1).sum()), tied_rows=tied, session_nnz=g.nnz), k3


def mmg_path(torch, card, profile_dir=None):
    """The last multimodal graph models: ``quick_start`` for each of
    ``MMG_RUNS`` (``quick_start_runs``: one epoch, ``evaluate`` valid and
    test; MGCN once more with bfloat16 evaluation, K5a and K5b). Checks
    beside the runs': LATTICE's per-step top-k (``check_lattice``) and its
    batch, and SLMRec's, on the card against the CPU; SMORE's fusion graph
    against the CPU's (``check_smore_fusion``); DAMRS's co-occurrence
    neighbours (``check_damrs_cooccurrence``); K1 forward and backward on
    GUME's augmented graph (not symmetric) and SMORE's fusion graph.
    ``profile_dir`` adds ten more training batches of each model under
    ``torch.profiler``. Returns (summary, kernel cases by kernel,
    launches)."""
    from genmmrec_tpu_torch.data.dataset import RecDataset

    cases = dict(k1=[], k1_bwd=[], k3=[])
    data = {}

    def train_ds(config):
        if "train" not in data:
            data["train"] = RecDataset(config).split()[0]
        return data["train"]

    def after(key, r, o):
        tr, model = r["trainer"], r["model"]
        if key == "LATTICE":
            k3, o["lattice"] = check_lattice(torch, tr, model, card)
            cases["k3"] += k3
            o["batch_vs_cpu"] = check_batch_against_cpu(
                torch, tr, model.data, train_ds(tr.config), tr.config, card,
                card_tensors=("image_original_adj", "text_original_adj"), replay_topk=True,
            )
        if key == "SLMRec":
            draws = model.draws(torch.Generator(device="cuda").manual_seed(SEED + 14))
            # a bias added to every row of the in-batch cross-entropy's second
            # view shifts each row's logits by one constant: zero but for rounding
            heads = {f"{h}.bias": f"{h}.weight" for h in ("g_v_iv", "g_t_ivat")}
            o["batch_vs_cpu"] = check_batch_against_cpu(
                torch, tr, model.data, train_ds(tr.config), tr.config, card, loss_kwargs=dict(draws=draws),
                zero_grads=heads,
            )
        if key == "GUME":
            cases["k1"] += check_spmm(torch, [("gume_augmented_d192", model.norm_adj, 3 * model.embedding_dim)],
                                      card)["cases"]
            cases["k1_bwd"].append(check_nonsymmetric_grad(torch, model.norm_adj, 3 * model.embedding_dim, card,
                                                           case="gume_augmented"))
        if key == "SMORE":
            k3, o["fusion_nnz"] = check_smore_fusion(torch, model, card)
            cases["k3"] += k3
            cases["k1"] += check_spmm(torch, [("smore_fusion_d64", model.fusion_adj, model.embedding_dim)],
                                      card)["cases"]
        if key == "DAMRS":
            o["cooccurrence"], k3 = check_damrs_cooccurrence(torch, model, train_ds(tr.config), card)
            cases["k3"] += k3
        if profile_dir:
            from torch.profiler import ProfilerActivity, profile

            gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
            B = tr.train_batch_size
            idx = torch.randperm(tr._num_batches * B, generator=gen, device="cuda")[: 10 * B].reshape(10, B)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                tr._train_epoch(gen, plan={"idx": idx})
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            write_profile(torch, prof, profile_dir, f"{key}_baby_train_10_batches", wall, card)

    phase_t0 = time.perf_counter()
    out, launches = quick_start_runs(torch, MMG_RUNS, card, "mmg_path", after)
    total = {k: sum(l[k] for l in launches.values()) for k in launch_counts()}
    out["phase_s"] = time.perf_counter() - phase_t0
    print(f"mmg_path phase done in {out['phase_s']:.1f} s; launches {json.dumps(launches)}")
    return dict(**out, launches=launches), cases, total


# the diffusion recommenders' runs of ``quick_start``, each at its published
# widths on Amazon-baby for one epoch (their YAMLs' only list is the seed);
# MVDiff through its own trainer (``get_trainer``), DiffGraph once more in
# bfloat16, which takes the fused route
DIFF_RUNS = (
    ("DiffRec", "DiffRec", {}, dict(max_epochs=1), ("grouped_topk",)),
    ("LD4MRec", "LD4MRec", {}, dict(max_epochs=1), ("grouped_topk",)),
    ("DDRM", "DDRM", {}, dict(max_epochs=1), MP_NEED),
    ("DiffGraph", "DiffGraph", {}, dict(max_epochs=1), MP_NEED),
    ("DiffGraph_bf16", "DiffGraph", {"eval_dtype": "bfloat16"}, dict(max_epochs=1),
     MP_NEED + ("fused_group_max", "fused_candidates")),
    ("MCDRec", "MCDRec", {}, dict(max_epochs=1), MP_NEED),
    ("CoDMR", "CoDMR", {}, dict(max_epochs=1), MP_NEED),
    ("MVDiff", "MVDiff", {}, dict(max_epochs=1), MP_NEED),
)
# Recall@20 (valid) of the JAX package's two-epoch smoke lane on Amazon-baby
# (``docs/ZOO_RESULTS.md``): printed beside the port's one epoch as context,
# not held
ZOO_SMOKE_RECALL20 = {
    "DiffRec": 0.1723, "LD4MRec": 0.1761, "DDRM": 0.0766, "DiffGraph": 0.1608, "MCDRec": 0.0151,
    "CoDMR": 0.0903, "MVDiff": 0.1341,
}


def batch_launches(torch, tr):
    """The kernels' launches in one training batch of ``tr`` (a seeded
    permutation's first batch), the counts set to 0 before it."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    B = tr.train_batch_size
    idx = torch.randperm(tr._num_batches * B, generator=gen, device="cuda")[:B].reshape(1, B)
    reset_counts()
    tr._train_epoch(gen, plan={"idx": idx})
    torch.cuda.synchronize()
    return launch_counts()


def diffrec_eval_bound(model, n_rows: int) -> float:
    """Seconds an evaluation of ``n_rows`` users takes at the card's peak
    float32 rate: the denoiser's products at every reverse step."""
    dnn = model.dnn
    macs = sum(l.in_features * l.out_features for l in [*dnn.in_layers, *dnn.out_layers])
    return 2.0 * macs * n_rows * model.sched.steps / F32_FLOPS


def check_mcdrec_graph(torch, tr, model, card):
    """MCDRec's graph after DGD: the values of this epoch over the edge
    layout built once (the same row pointer and long-row list), K1 forward
    and backward on them against the plain version."""
    vals = tr.state["graph_vals"]
    g = model.ui.graph(vals)
    first = model.init_state()["graph_vals"]
    kept = int((vals[: model.n_edges * 2] != 0).sum()) // 2
    n_keep = max(1, int(model.n_edges * (1.0 - model.rho)))
    if g.row_ptr is not model.ui.structure.row_ptr or kept < n_keep or torch.equal(vals, first):
        raise AssertionError(f"MCDRec's DGD graph: {kept} pairs kept (at least {n_keep}), layout shared "
                             f"{g.row_ptr is model.ui.structure.row_ptr}, values changed {not torch.equal(vals, first)}")
    print(f"MCDRec DGD graph: {kept} of {model.n_edges} pairs kept ({n_keep} by the threshold, ties kept), the values "
          f"of this epoch over the layout built once [{card}]")
    fwd = check_spmm(torch, [("mcdrec_dgd_graph_d64", g, model.latent_dim)], card)["cases"]
    bwd = check_spmm_backward(torch, [("mcdrec_dgd_graph_d64", g, model.latent_dim)], card)["cases"]
    return fwd, bwd, dict(pairs_kept=kept, n_keep=n_keep)


def check_mvdiff_rebuild(torch, tr, model, card):
    """MVDiff's phase 4 again, timed, its denoised rows recorded; then the
    same on those rows with every top-k taken by K3's plain version and the
    same dropout draws: both user-item graphs equal. K3 against its plain
    version on the first chunk's tie-heavy high-order rows ((B·10, 7,050),
    k = 10) and on its denoised scores ((B, 7,050), k = 10)."""
    import genmmrec_tpu_torch.models.mvdiff as MV
    from genmmrec_tpu_torch.ops.topk import grouped_topk, grouped_topk_plain

    recorded = []
    own = model.sparsity_p_sample

    def recording(dn, x):
        out = own(dn, x)
        recorded.append(out)
        return out

    def rebuild():
        tr.regenerate_users(torch.Generator(device="cuda").manual_seed(SEED + 16))
        return {m: tr.state[f"{m}_ui"] for m in ("image", "text")}

    model.sparsity_p_sample = recording
    try:
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card_graphs = rebuild()
        torch.cuda.synchronize()
        rebuild_s = time.perf_counter() - t0
        launches = launch_counts()
        replay = list(recorded)
        model.sparsity_p_sample = lambda dn, x: replay.pop(0)
        MV.grouped_topk = grouped_topk_plain
        plain_graphs = rebuild()
    finally:
        MV.grouped_topk = grouped_topk
        del model.sparsity_p_sample
    for m, g in card_graphs.items():
        p = plain_graphs[m]
        if not all(torch.equal(getattr(g, f), getattr(p, f)) for f in ("rows", "cols", "vals", "row_ptr")):
            raise AssertionError(f"MVDiff phase 4: the {m} graph on K3 differs from the plain version's")
    if launches["grouped_topk"] <= 0:
        raise AssertionError(f"MVDiff phase 4 launched no K3: {launches}")
    den = recorded[0]
    rk = model.rebuild_k
    _, interest = grouped_topk(den, rk)
    sim = (tr.state["image_ii_dense"][interest] * tr.state["text_ii_dense"][interest]).reshape(-1, model.n_items)
    zeros = float((sim == 0).float().mean())
    print(f"MVDiff phase 4: {rebuild_s:.3f} s, both user-item graphs on K3 equal to the plain version's on the same "
          f"denoised rows (image nnz {card_graphs['image'].nnz}, text nnz {card_graphs['text'].nnz}); the high-order "
          f"rows {tuple(sim.shape)} are {100 * zeros:.2f}% exact zeros; launches {json.dumps(launches)} [{card}]")
    k3 = check_k3(torch, [("mvdiff_high_order_top10", sim, rk, None), ("mvdiff_denoised_top10", den, rk, None)],
                  card)["cases"]
    return k3, dict(rebuild_s=rebuild_s, launches=launches, high_order_zero_share=zeros)


def diff_path(torch, card, profile_dir=None):
    """The diffusion recommenders: ``quick_start`` for each of ``DIFF_RUNS``
    (``quick_start_runs``: one epoch, ``evaluate`` valid and test; MVDiff's
    four phases through ``MVDiffTrainer``; DiffGraph once more with
    bfloat16 evaluation, K5a and K5b). Beside each run: one training batch's
    launches, Recall@20 beside the JAX two-epoch smoke value. Checks:
    DiffRec's and MCDRec's batch on the card against the CPU (draws made on
    the card and handed to both); MCDRec's graph after DGD under K1
    (``check_mcdrec_graph``); DiffGraph's ``propagate`` and CoDMR's
    self-looped graph under K1, CoDMR's KNN rows under K3; MVDiff's phase 4
    (``check_mvdiff_rebuild``). DiffRec's evaluation beside its bound.
    ``profile_dir`` adds ten more training batches of each model under
    ``torch.profiler``. Returns (summary, kernel cases by kernel,
    launches)."""
    from genmmrec_tpu_torch.data.dataset import RecDataset

    cases = dict(k1=[], k1_bwd=[], k3=[])
    data = {}

    def train_ds(config):
        if "train" not in data:
            data["train"] = RecDataset(config).split()[0]
        return data["train"]

    def after(key, r, o):
        tr, model = r["trainer"], r["model"]
        dev = model.device
        gen = torch.Generator(device=dev).manual_seed(SEED + 17)
        B = tr.train_batch_size
        if key == "DiffRec":
            rows = r["test_data"].users.shape[0]
            bound = diffrec_eval_bound(model, rows)
            o["eval_test_bound_s"] = bound
            print(f"DiffRec evaluate(test): {o['test_s'][-1][-1]:.3f} s for {rows} users x {model.sched.steps} "
                  f"reverse steps, bound {bound:.3f} s (float32 operations at {F32_FLOPS / 1e12:.0f} TFLOP/s) [{card}]")
            draws = dict(ts=torch.randint(0, model.steps, (B,), generator=gen, device=dev),
                         noise=torch.randn(B, model.n_items, generator=gen, device=dev),
                         keep=torch.rand(B, model.n_items, generator=gen, device=dev) < 1.0 - model.dropout)
            o["batch_vs_cpu"] = check_batch_against_cpu(torch, tr, model.data, train_ds(tr.config), tr.config, card,
                                                        loss_kwargs=draws)
        if key == "MCDRec":
            f, b, o["dgd"] = check_mcdrec_graph(torch, tr, model, card)
            cases["k1"] += f
            cases["k1_bwd"] += b
            ts, noise = model.draws(gen, B)
            biases = {f"unet.{blk}.{c}.bias": f"unet.{blk}.{c}.weight"
                      for blk in ("enc1", "enc2", "dec1") for c in ("c1", "c2")}
            o["batch_vs_cpu"] = check_batch_against_cpu(torch, tr, model.data, train_ds(tr.config), tr.config, card,
                                                        loss_kwargs=dict(ts=ts, noise=noise), zero_grads=biases)
        if key == "DiffGraph":
            f, b = check_propagate(torch, [("diffgraph_ui_add_d64", model.graph, "add", model.latdim)], card)
            cases["k1"] += f
            cases["k1_bwd"] += b
        if key == "CoDMR":
            cases["k1"] += check_spmm(torch, [("codmr_self_looped_ui_d64", model.uiMat, model.hide_dim)],
                                      card)["cases"]
            f = torch.nn.functional.normalize(model.t_feat, dim=1)
            cases["k3"] += check_k3(torch, [("codmr_text_knn_top10", f[:4096] @ f.T, model.knn_k, None)],
                                    card)["cases"]
        if key == "MVDiff":
            k3, o["phase4"] = check_mvdiff_rebuild(torch, tr, model, card)
            cases["k3"] += k3
            o["prelude"] = dict(tr.prelude_log)
            print(f"MVDiff phases: {json.dumps({k: round(v, 4) for k, v in tr.prelude_log.items()})} [{card}]")
        per_batch = batch_launches(torch, tr)
        o["batch_launches"] = per_batch
        base = key.split("_")[0]
        print(f"diff_path {key}: one training batch launches K1 {per_batch['segment_spmm']} + "
              f"{per_batch['segment_spmm_backward']}, K3 {per_batch['grouped_topk']}; Recall@20 valid "
              f"{o['valid_recall20']:.4f} after one epoch (JAX two-epoch smoke {ZOO_SMOKE_RECALL20[base]}) [{card}]")
        if profile_dir:
            from torch.profiler import ProfilerActivity, profile

            pgen = torch.Generator(device="cuda").manual_seed(SEED + 12)
            idx = torch.randperm(tr._num_batches * B, generator=pgen, device="cuda")[: 10 * B].reshape(10, B)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                tr._train_epoch(pgen, plan={"idx": idx})
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            write_profile(torch, prof, profile_dir, f"{key}_baby_train_10_batches", wall, card)

    phase_t0 = time.perf_counter()
    out, launches = quick_start_runs(torch, DIFF_RUNS, card, "diff_path", after)
    total = {k: sum(l[k] for l in launches.values()) for k in launch_counts()}
    out["phase_s"] = time.perf_counter() - phase_t0
    print(f"diff_path phase done in {out['phase_s']:.1f} s; launches {json.dumps(launches)}")
    return dict(**out, launches=launches), cases, total


RF_ONE = {"rf_loss_weight": 0.2}
RF_HOSTS = (
    "RFFREEDOM", "RFLATTICE", "RFMGCN", "RFMMGCN", "RFVBPR", "RFLGMRec", "RFBPR_remove", "RFLightGCN_remove",
    "RFLayerGCN_remove", "RFDualGNN", "RFGRCN", "RFCOHESION", "RFSMORE", "RFPGL",
)
# the kernels a run must launch: K3 evaluates every model; K1 forward and
# backward propagate every host with a graph. RFBPR_remove has none (its
# zero condition is built without a product); RFVBPR lifts its raw
# features through R once, at set-up.
RF_NEED = {"RFBPR_remove": ("grouped_topk",), "RFVBPR": ("grouped_topk", "segment_spmm")}
RF_RUNS = tuple(
    (name, name, dict(RF_ONE), dict(max_epochs=1), RF_NEED.get(name, MP_NEED))
    for name in ("RFGUME", "RFGUMETime", "RFMRec", "GenRecBM3", "RFBM3") + RF_HOSTS
) + (
    # warm-up 0: the generated term reaches the scores, convexly (RFGUMETime)
    # and additively (GenRecBM3)
    ("RFGUMETime_warm", "RFGUMETime", {**RF_ONE, "rf_warmup_epochs": 0}, dict(max_epochs=1), MP_NEED),
    ("GenRecBM3_warm", "GenRecBM3", {**RF_ONE, "rf_warmup_epochs": 0}, dict(max_epochs=1), MP_NEED),
    ("RFBM3_bf16", "RFBM3", {**RF_ONE, "eval_dtype": "bfloat16"}, dict(max_epochs=1),
     MP_NEED + ("fused_group_max", "fused_candidates")),
)
ZOO_SMOKE_RECALL20.update({
    "RFGUME": 0.0294, "RFGUMETime": 0.0294, "RFMRec": 0.0017, "GenRecBM3": 0.1789, "RFBM3": 0.1402,
    "RFFREEDOM": 0.1655, "RFLATTICE": 0.1558, "RFMGCN": 0.1642, "RFMMGCN": 0.1764, "RFVBPR": 0.0013,
    "RFLGMRec": 0.1791, "RFBPR_remove": 0.0864, "RFLightGCN_remove": 0.1754, "RFLayerGCN_remove": 0.0000,
    "RFDualGNN": 0.1347, "RFGRCN": 0.0774, "RFCOHESION": 0.1701, "RFSMORE": 0.0139, "RFPGL": 0.1788,
})
# the models whose training batches ``--profile`` profiles in rf_path
RF_PROFILED = ("RFGUME", "RFMRec", "GenRecBM3")


def check_sliced_spmm(torch, name, g, d, card):
    """``ops.graph.spmm`` at a width past K1's 512 columns (cut into column
    slices, one K1 launch each) against the plain product of the whole
    width and ``torch.sparse.mm``; K1 forward launches counted. Each
    element is held to K1_RTOL · Σ|vals·x| + K1_ATOL."""
    from genmmrec_tpu_torch.ops import segment as S
    from genmmrec_tpu_torch.ops.graph import KERNEL_MAX_D, spmm

    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    x = torch.randn(g.n_cols, d, generator=gen, device="cuda")
    before = S.segment_spmm.launches
    out = spmm(g, x)
    launched = S.segment_spmm.launches - before
    plain = lambda: S.segment_spmm_plain(g.row_ptr, g.cols, g.vals, x, g.n_rows)
    ref = plain()
    magnitude = S.segment_spmm_plain(g.row_ptr, g.cols, g.vals.abs(), x.abs(), g.n_rows)
    csr = torch.sparse_csr_tensor(g.row_ptr, g.cols, g.vals, size=(g.n_rows, g.n_cols), check_invariants=False)
    lib = torch.sparse.mm(csr, x)
    torch.cuda.synchronize()
    diff = (out - ref).abs()
    e = diff.max().item()
    want = -(-d // KERNEL_MAX_D)
    if launched != want or not bool((diff <= K1_RTOL * magnitude + K1_ATOL).all()):
        raise AssertionError(f"K1 {name}: {launched} launches (want {want}), differs from the plain product by {e:.3e}")
    if not bool(((out - lib).abs() <= K1_RTOL * magnitude + K1_ATOL).all()) or not torch.equal(spmm(g, x), out):
        raise AssertionError(f"K1 {name}: differs from torch.sparse.mm or between two calls")
    del diff, magnitude, lib
    k_ms, p_ms = timed_pair(torch, lambda: spmm(g, x), plain)
    l_ms = cuda_ms(torch, lambda: torch.sparse.mm(csr, x))
    b = Bound().add(nbytes(g.row_ptr, g.cols, g.vals, x, out), 2.0 * g.nnz * d, F32_FLOPS)
    print(f"K1 {name}: n_rows={g.n_rows} nnz={g.nnz} d={d} in {launched} column slices, max_abs_err={e:.3e} "
          f"repeatable, sliced spmm {k_ms:.4f} ms, plain {p_ms:.4f} ms, torch.sparse.mm {l_ms:.4f} ms, bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']}) [{card}]")
    return dict(case=name, n_rows=g.n_rows, nnz=g.nnz, d=d, slices=launched, max_abs_err=e, ms=k_ms, plain_ms=p_ms,
                library_ms=l_ms, **b)


def check_rf_warm(torch, tr, model, card):
    """A run with ``rf_warmup_epochs`` 0: the generated term reaches the
    scores. The first evaluation chunk's scores with it, and again with the
    warm-up moved past the epoch (the term multiplied by 0): both finite,
    and they differ."""
    users = torch.arange(min(tr.eval_batch_size, model.n_users), device=model.device)
    cfg = model.rf_cfg
    with torch.no_grad():
        warm = model.scores_cached(tr.state, users, model.full_embeddings(tr.state))
        kept, cfg.warmup_epochs = cfg.warmup_epochs, 10**9
        try:
            cold = model.scores_cached(tr.state, users, model.full_embeddings(tr.state))
        finally:
            cfg.warmup_epochs = kept
    apart = (warm - cold).abs().max().item()
    if not (bool(torch.isfinite(warm).all()) and bool(torch.isfinite(cold).all()) and apart > 0):
        raise AssertionError(f"{type(model).__name__} warm: scores not finite or the generated term moved none "
                             f"({apart})")
    print(f"{type(model).__name__} with rf_warmup_epochs 0: the generated term moves {users.shape[0]} users' scores "
          f"by up to {apart:.4e} (finite) [{card}]")
    return dict(warm_scores_max_abs_diff=apart)


def check_rf_groups(torch, tr, model, initial, card):
    """The ``"rf"`` parameters moved in the epoch (against ``fit``'s
    initialization); one more batch stepped by copies of the main
    optimizer alone leaves them bit-unchanged and moves the ``rec`` ones."""
    named = dict(model.named_parameters())
    still = [n for n, p in initial.items() if torch.equal(p, named[n].detach())]
    if not initial or still:
        raise AssertionError(f"{type(model).__name__}: rf parameters unmoved by the epoch: {still or 'none kept'}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    B = tr.train_batch_size
    idx = torch.randperm(tr._td.n_inter, generator=gen, device="cuda")[:B]
    td = tr._td
    batch = {"users": td.users[idx], "pos": td.items[idx], "neg": td.items[idx.flip(0)],
             "weight": torch.ones(B, device="cuda")}
    before = {n: p.detach().clone() for n, p in named.items()}
    main = batch_optimizers(model, tr)[0]
    with torch.enable_grad():
        model.zero_grad(set_to_none=True)
        model.loss(tr.state, batch, gen)[0].backward()
        main.step()
    model.zero_grad(set_to_none=True)
    rf_same = all(torch.equal(before[n], named[n].detach()) for n in initial)
    rec_moved = any(not torch.equal(before[n], p.detach()) for n, p in named.items() if n not in initial)
    with torch.no_grad():
        for n, p in named.items():
            p.copy_(before[n])
    if not (rf_same and rec_moved):
        raise AssertionError(f"{type(model).__name__}: a main step moved rf ({not rf_same}) or no rec ({not rec_moved})")
    print(f"{type(model).__name__}: all {len(initial)} rf tensors moved in the epoch; a step of the main optimizer "
          f"alone leaves them bit-unchanged [{card}]")


def rf_path(torch, card, profile_dir=None):
    """The Rectified-Flow family: ``quick_start`` for each of ``RF_RUNS``
    (``quick_start_runs``: one epoch, ``evaluate`` valid and test, the YAML's
    ``rf_loss_weight`` set to 0.2): RFGUME, RFGUMETime, RFMRec, GenRecBM3,
    RFBM3, the 14 thin hosts, then RFGUMETime and GenRecBM3 with
    ``rf_warmup_epochs`` 0 and RFBM3 with bfloat16 evaluation (K5a, K5b).
    Beside each run: one training batch's launches, Recall@20 beside the
    JAX two-epoch smoke value. Checks: RFGUME's and RFMRec's batch on the
    card against the CPU (every draw made on the card and handed to both;
    every gradient, the ``rf`` subtree's too, and the parameters
    after the main optimizer and the ``"rf"`` AdamW stepped); K1 on RFBM3's
    R at d = 64 and on RFDualGNN's at d = 4,096 (the sliced product) and
    on RFMRec's weighted adjacency at d = 64, forward and backward; the
    causal denoiser's layout with one batch's values (GenRecBM3); the
    ``_warm`` runs' scores with and without the generated term; for every
    model with an ``"rf"`` group, its parameters moved by the epoch and left
    bit-unchanged by the main optimizer alone. ``profile_dir`` adds ten
    profiled training batches of RFGUME, RFMRec and GenRecBM3. Returns
    (summary, kernel cases by kernel, launches)."""
    from genmmrec_tpu_torch.data.dataset import RecDataset

    cases = dict(k1=[], k1_bwd=[], k3=[])
    data = {}

    def train_ds(config):
        if "train" not in data:
            data["train"] = RecDataset(config).split()[0]
        return data["train"]

    def after(key, r, o):
        tr, model = r["trainer"], r["model"]
        dev = model.device
        gen = torch.Generator(device=dev).manual_seed(SEED + 23)
        B = tr.train_batch_size
        base = key.split("_warm")[0].split("_bf16")[0]
        if key in ("RFGUME", "RFMRec"):
            graphs = {}
            if key == "RFGUME":
                draws = dict(noise=model.draws(gen), rf_draws=model.rf_draws(gen, B, tr.state["epoch"]))
                # each device ranks its own float32 similarities: near-equal
                # neighbours may swap in the KNN graphs, and the augmented
                # graph follows them
                graphs = dict(card_graphs=("image_original_adj", "text_original_adj"),
                              card_derived=("norm_adj", "R"))
            else:
                draws = dict(draws=model.draws(gen, B))
                # a key bias adds one constant to a query's logits, which
                # the softmax cancels; the self-attention's one key takes
                # probability 1 whatever its projections: gradients zero but
                # for rounding, held against the value projection's
                vel = "velocity.{}.{}.attn.{}"
                graphs = dict(zero_grads={
                    **{vel.format("cross", i, "bk"): vel.format("cross", i, "wv") for i in range(model.n_layers)},
                    **{vel.format("selfa", i, w): vel.format("selfa", i, "wv") for i in range(model.n_layers)
                       for w in ("wq", "wk", "bq", "bk")},
                })
            groups = tuple(model.param_groups())
            kept = {}
            if key == "RFGUME":
                # the first layer of GUME's modal attention: its bias
                # gradient is a cancellation of the two modal rows' tanh
                # slopes at the initialization's small inputs, 1e-2 of the
                # weight's, below float32 rounding of the sum. It is widened
                # for the check, as the CPU tests widen it, and restored
                layer = model.separate1
                kept = {n: p.detach().clone() for n, p in layer.named_parameters()}
                with torch.no_grad():
                    layer.weight.mul_(30.0)
                    layer.bias.copy_(0.5 * torch.randn(layer.bias.shape, generator=gen, device=dev))
            o["batch_vs_cpu"] = check_batch_against_cpu(torch, tr, model.data, train_ds(tr.config), tr.config, card,
                                                        loss_kwargs=draws, groups=groups, step=True, **graphs)
            with torch.no_grad():
                for n, p in (model.separate1.named_parameters() if kept else ()):
                    p.copy_(kept[n])
        if key == "RFMRec":
            g = model.norm_adj
            cases["k1"] += check_spmm(torch, [("rfmrec_weighted_adjacency_d64", g, model.embedding_dim)],
                                      card)["cases"]
            cases["k1_bwd"] += check_spmm_backward(torch, [("rfmrec_weighted_adjacency_d64", g, model.embedding_dim)],
                                                   card)["cases"]
        if key == "RFBM3":
            cases["k1"] += check_spmm(torch, [("rf_R_d64", model._rf_R, model.embedding_dim)], card)["cases"]
        if key == "RFDualGNN":
            cases["k1"].append(check_sliced_spmm(torch, "rf_R_d4096_sliced", model._rf_R, model.v_feat.shape[1], card))
        if key == "GenRecBM3":
            cd = model.causal_denoiser
            with torch.no_grad():
                g = cd.ipw_graph(cd.propensity(model._ego()))
            cases["k1"] += check_spmm(torch, [("genrecbm3_ipw_layout_d64", g, model.embedding_dim)], card)["cases"]
        if key.endswith("_warm"):
            o["warm"] = check_rf_warm(torch, tr, model, card)
        if "rf" in model.label_transforms():
            check_rf_groups(torch, tr, model, r["initial"], card)
        per_batch = batch_launches(torch, tr)
        o["batch_launches"] = per_batch
        print(f"rf_path {key}: one training batch launches K1 {per_batch['segment_spmm']} + "
              f"{per_batch['segment_spmm_backward']}, K3 {per_batch['grouped_topk']}; Recall@20 valid "
              f"{o['valid_recall20']:.4f} after one epoch (JAX two-epoch smoke {ZOO_SMOKE_RECALL20[base]}) [{card}]")
        if profile_dir and key in RF_PROFILED:
            from torch.profiler import ProfilerActivity, profile

            pgen = torch.Generator(device="cuda").manual_seed(SEED + 12)
            idx = torch.randperm(tr._num_batches * B, generator=pgen, device="cuda")[: 10 * B].reshape(10, B)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                tr._train_epoch(pgen, plan={"idx": idx})
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            write_profile(torch, prof, profile_dir, f"{key}_baby_train_10_batches", wall, card)

    phase_t0 = time.perf_counter()
    out, launches = quick_start_runs(torch, RF_RUNS, card, "rf_path", after)
    total = {k: sum(l[k] for l in launches.values()) for k in launch_counts()}
    out["phase_s"] = time.perf_counter() - phase_t0
    print(f"rf_path phase done in {out['phase_s']:.1f} s; launches {json.dumps(launches)}")
    return dict(**out, launches=launches), cases, total



# -- the multi-device layer: DiffMM on a mesh of ranks sharing the card -------
MESH_SHAPE = {"data": 2, "model": 2}
# a mesh fit against one rank: the JAX package's bound on its sharded fits
MESH_METRIC_ATOL = 2e-3
# the evaluation's chunk and k of the collectives' timing
MESH_TOPK_SHAPE = (4096, 50)


def mesh_setup(torch, dev):
    """DiffMM on Amazon-baby at its published width through ``get_model``,
    one epoch: (config, train data, valid, test, model)."""
    from genmmrec_tpu_torch import native
    from genmmrec_tpu_torch.config import Config
    from genmmrec_tpu_torch.data.arrays import build_eval_data, build_train_data
    from genmmrec_tpu_torch.data.dataset import RecDataset
    from genmmrec_tpu_torch.engine.evaluator import group_masks
    from genmmrec_tpu_torch.models import get_model

    config = Config("DiffMM", "baby", {"save_recommended_topk": False, "epochs": 1, "eval_step": 1})
    train, valid, test = RecDataset(config).split()
    eval_bs = int(config["eval_batch_size"])
    td = build_train_data(train, dev)
    vd, ted = build_eval_data(valid, train, eval_bs, dev), build_eval_data(test, train, eval_bs, dev)
    config["pop_mask"], config["warm_mask"] = group_masks(train, dev)
    return config, td, vd, ted, get_model("DiffMM")(config, td)


def mesh_drive(torch, make_trainer, model, vd, ted):
    """Twice, each time with a new trainer from ``make_trainer()``: ``fit``
    (one epoch: phase 1, the regeneration, the BPR + InfoNCE epoch, then
    evaluate valid and test in float32), then evaluate valid and test in
    bfloat16. The first drive warms the process up (its CUDA context,
    cuBLAS, the kernel library, first calls) and only its wall time is
    kept; the second is timed and its launches counted → (trainer, results,
    seconds, launches, launches of the bf16 evaluation)."""
    for drive in ("cold", "warm"):
        trainer = make_trainer()
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, valid32, test32 = trainer.fit(trainer.model.data, vd, ted, verbose=False)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        model.eval_dtype = torch.bfloat16
        before = launch_counts()
        valid16, test16 = trainer.evaluate(vd), trainer.evaluate(ted, is_test=True)
        launches = launch_counts()
        bf16_launches = {k: v - before[k] for k, v in launches.items()}
        model.eval_dtype = torch.float32
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if drive == "cold":
            cold_s = t2 - t0
    res = dict(valid_float32=valid32, test_float32=test32, valid_bfloat16=valid16, test_bfloat16=test16)
    times = dict(fit_s=t1 - t0, epoch_s=trainer.epoch_times[0], bf16_eval_s=t2 - t1, total_s=t2 - t0,
                 first_drive_s=cold_s, **{k: v for k, v in trainer.prelude_log.items() if k.endswith("_s")})
    return trainer, res, times, launches, bf16_launches


def mesh_batch_check(torch, trainer, model, mesh):
    """One BPR batch of the trained model split over the data axis, its
    gradients summed over the axis, against the same batch on this one rank
    (rank 0): the loss within LOSS_RTOL, each gradient element within
    GRAD_RTOL of its magnitude plus GRAD_ATOL of its tensor's largest (of a
    table held as rows, rank 0's rows). Both batches read the tables whole
    from one gather (``whole_tables``), which every rank enters."""
    from genmmrec_tpu_torch.parallel import mesh as pm

    dev = model.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    B = trainer.train_batch_size
    idx = torch.randint(0, model.data.n_inter, (B,), generator=gen, device=dev)
    batch = {"users": model.data.users[idx], "pos": model.data.items[idx],
             "neg": torch.randint(0, model.n_items, (B,), generator=gen, device=dev),
             "weight": (torch.arange(B, device=dev) < B - 7).to(torch.float32)}
    params = dict(model.named_parameters())
    rows = pm.DataRows(mesh, B)
    with torch.enable_grad(), pm.whole_tables(model):
        model.zero_grad(set_to_none=True)
        total, _ = model.loss(trainer.state, {**rows.local(batch), "rows": rows})
        total.backward()
        pm.reduce_grads(params.values(), mesh)
        loss = float(pm.all_reduce(total.detach().clone(), mesh, pm.DATA_AXIS))
        summed = {k: p.grad.clone() for k, p in params.items()}
        if not mesh.is_main:
            return None
        model.zero_grad(set_to_none=True)
        ref, _ = model.loss(trainer.state, batch)
        ref.backward()
    if abs(loss - ref.item()) > LOSS_RTOL * abs(ref.item()):
        raise AssertionError(f"mesh batch: loss {loss} against one rank's {ref.item()}")
    worst = 0.0
    for k, p in params.items():
        g_ref = torch.zeros_like(p) if p.grad is None else p.grad
        bound = GRAD_RTOL * g_ref.abs() + GRAD_ATOL * g_ref.abs().max()
        share = ((summed[k] - g_ref).abs() / bound.clamp(min=1e-30)).max().item()
        if share > 1.0:
            raise AssertionError(f"mesh batch: gradient of {k} off by {share:.3f} of its bound")
        worst = max(worst, share)
    model.zero_grad(set_to_none=True)
    return dict(loss=loss, loss_one_rank=ref.item(), worst_share_of_bound=worst)


# the models whose batches split over the data axis besides BPR, LightGCN,
# DiffMM, GenRecV1 and DiffRec: graph-CF, multimodal, message passing,
# multimodal graph; then the diffusion recommenders, MVDiff and the
# Rectified-Flow family
MESH_FAMILY_MODELS = (
    "LayerGCN", "SELFCFED_LGN", "VBPR", "BM3", "FREEDOM", "ItemKNNCBF", "MMGCN", "GRCN", "DualGNN", "DRAGON",
    "COHESION", "MVGAE", "GUME", "LATTICE", "MGCN", "LGMRec", "SMORE", "PGL", "SLMRec", "DAMRS",
    "LD4MRec", "DDRM", "DiffGraph", "MCDRec", "CoDMR", "MVDiff",
    "RFGUME", "RFGUMETime", "GenRecBM3", "RFMRec", "RFBM3", "RFBPR_remove", "RFLightGCN_remove",
    "RFLayerGCN_remove", "RFVBPR", "RFFREEDOM", "RFLATTICE", "RFMMGCN", "RFGRCN", "RFDualGNN", "RFCOHESION",
    "RFMGCN", "RFSMORE", "RFLGMRec", "RFPGL",
)
# the models whose loss reads no graph (the RF hosts' conditions are built
# once at set-up), and so launches no K1
MESH_NO_PROPAGATION = ("VBPR", "ItemKNNCBF", "LD4MRec", "RFBPR_remove", "RFVBPR")
# the models whose training step launches K3
MESH_K3_IN_STEP = ("LATTICE", "DAMRS", "RFLATTICE")
# gradients that are zero but for rounding (a bias in front of a batch
# norm; an attention key bias, which adds one constant to a query's logits,
# and, over the self-attention's one key, the query and key projections),
# each held within MESH_BATCH_GRAD_ATOL of its weight's largest gradient:
# model -> [(pattern of the parameter, the weight's name by re.sub)]
MESH_ZERO_GRADS = {
    "MCDRec": [(r"^(unet\.(enc1|enc2|dec1)\.c[12]\.)bias$", r"\1weight")],
    "RFMRec": [(r"^(velocity\.cross\.\d+\.attn\.)bk$", r"\1wv"),
               (r"^(velocity\.selfa\.\d+\.attn\.)(wq|wk|bq|bk)$", r"\1wv")],
}
# the layers whose gradients are sums of row terms that cancel, held on the
# scale of the terms (the sum of their magnitudes, where the rounding of
# such a sum lies): the loss cancels a bias exactly (FREEDOM's projections
# shift both scores of a pair, SLMRec's second views every logit of a row),
# or a layer's two calls nearly cancel at a random start (MGCN's and GUME's
# modal attention scores the image and the text view of each row through
# the same layers into a softmax over the two)
MESH_ON_TERMS = {
    "FREEDOM": ("image_trs", "text_trs"), "SLMRec": ("g_v_iv", "g_t_ivat"), "MGCN": ("query1", "query2"),
    "GUME": ("separate1", "separate2"), "RFFREEDOM": ("image_trs", "text_trs"), "RFMGCN": ("query1", "query2"),
    "RFGUME": ("separate1", "separate2"), "RFGUMETime": ("separate1", "separate2"),
    # the linear layers in front of MVDiff's batch norms (over whole
    # tables): their biases' gradients cancel to rounding
    "MVDiff": tuple(f"{m}_{part}.{i}.lin" for m in ("image", "text") for part, n in (("residual", 3), ("modal", 2))
                    for i in range(n)) + ("gate_image.lin", "gate_text.lin", "common1.lin"),
}
# the same for weights that enter a product ``x @ W.T`` and biases added
# after it (parameters that are not an ``nn.Linear``'s), by a pattern of
# their names: RFMRec's attention projections at the published 6 × 512,
# whose deepest layers' gradients carry float32 rounding past
# MESH_BATCH_GRAD_ATOL of their largest on one device too
# (``tests/test_torch_rfmrec_width.py`` holds them in float64)
MESH_ON_PROJECTIONS = {"RFMRec": r"^velocity\.(cross|selfa)\.\d+\.attn\.[wb][qkvo]$"}
# a batch split over the data axis against the global batch on one rank; a
# gradient of MESH_ON_TERMS within MESH_TERMS_ATOL of its terms' scale
MESH_BATCH_LOSS_RTOL = 1e-5
MESH_BATCH_GRAD_RTOL, MESH_BATCH_GRAD_ATOL = 1e-4, 1e-5
MESH_TERMS_ATOL = 1e-4
# the kernels of a training step
STEP_KERNELS = ("segment_spmm", "segment_spmm_backward", "grouped_topk")


def held_table_bytes(torch, trainer, names=None) -> dict:
    """name -> {param, grad, moments}: the bytes that this rank holds of
    each table held at rest as its rows (``TableRows``, the placement of
    ``fit`` on a model axis), or, given ``names``, of those parameters (one
    rank's, whole): the parameter, its gradient in one BPR batch of the
    trained model (the first ``train_batch_size`` interactions; the tables
    read whole through ``whole_tables``, which every rank enters) and the
    optimizers' moments of it."""
    from genmmrec_tpu_torch.parallel import mesh as pm

    model = trainer.model
    params = dict(model.named_parameters())
    if names is None:
        names = sorted(k for k, p in params.items() if isinstance(getattr(p, "held_rows", None), pm.TableRows))
    dev = model.device
    idx = torch.arange(trainer.train_batch_size, device=dev) % model.data.n_inter
    batch = {"users": model.data.users[idx], "pos": model.data.items[idx], "neg": model.data.items[idx.flip(0)],
             "weight": torch.ones(idx.shape[0], device=dev)}
    with torch.enable_grad():
        model.zero_grad(set_to_none=True)
        with pm.whole_tables(model):
            total, _ = model.loss_and_update(trainer.state, batch, torch.Generator(device=dev).manual_seed(SEED + 61))
        total.backward()
    moments = {id(p): sum(v.nbytes for v in opt.state[p].values() if torch.is_tensor(v))
               for opt in trainer.optimizers.values() for group in opt.param_groups for p in group["params"]}
    nbytes = lambda t: 0 if t is None else t.nbytes
    out = {k: dict(param=params[k].nbytes, grad=nbytes(params[k].grad), moments=moments.get(id(params[k]), 0))
           for k in names}
    model.zero_grad(set_to_none=True)
    return out


def check_held_halves(name, per_rank: list, one: dict, card) -> list:
    """Each rank's bytes of each table it holds as rows (``held_table_bytes``)
    against one rank's of the whole table: the parameter, its gradient and
    its moments each exactly half (the model axis of 2), none zero, and the
    same tables on every rank; prints a line a rank, returns the failures."""
    failures = []
    for r, held in enumerate(per_rank):
        if not held or held.keys() != per_rank[0].keys():
            failures.append(f"{name}: mesh rank {r} holds {sorted(held)} as rows, rank 0 {sorted(per_rank[0])}")
        for k, b in held.items():
            off = [part for part, v in b.items() if not (v > 0 and 2 * v == one[k][part])]
            if off:
                failures.append(f"{name}: mesh rank {r}'s {k} holds {b}, not half of one rank's {one[k]}")
        print(f"{name} mesh rank {r} holds as its rows: " + "; ".join(
            f"{k} param {b['param']} B, grad {b['grad']} B, moments {b['moments']} B (one rank {one[k]['param']}, "
            f"{one[k]['grad']}, {one[k]['moments']} B)" for k, b in held.items()) + f" [{card}]")
    return failures


# the models fitted one epoch on the mesh against one rank: MGCN, and
# MVDiff (its four phases through MVDiffTrainer, then the BPR epoch), each
# at its published config
MESH_FITS = ("MGCN", "MVDiff")


def mesh_fit_setup(torch, dev, name):
    """``name`` on Amazon-baby at its published width through
    ``get_model``, one epoch: (config, train data, valid, model)."""
    from genmmrec_tpu_torch import native
    from genmmrec_tpu_torch.config import Config
    from genmmrec_tpu_torch.data.arrays import build_eval_data, build_train_data
    from genmmrec_tpu_torch.data.dataset import RecDataset
    from genmmrec_tpu_torch.engine.evaluator import group_masks
    from genmmrec_tpu_torch.models import get_model

    config = Config(name, "baby", {"save_recommended_topk": False, "epochs": 1, "eval_step": 1})
    train, valid, _ = RecDataset(config).split()
    td = build_train_data(train, dev)
    vd = build_eval_data(valid, train, int(config["eval_batch_size"]), dev)
    config["pop_mask"], config["warm_mask"] = group_masks(train, dev)
    return config, td, vd, get_model(name)(config, td)


def mesh_fit_drive(torch, name, config, model, td, vd, mesh=None, held_names=None) -> dict:
    """``fit`` of one epoch with evaluate(valid) in float32, timed, its
    launches counted; a multi-phase trainer's phase times beside; after
    it, the bytes of the tables held as rows (``held_table_bytes``; on one
    rank, of ``held_names``)."""
    from genmmrec_tpu_torch.engine.trainer import get_trainer

    trainer = get_trainer(name)(config, model, mesh=mesh)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, valid, _ = trainer.fit(td, vd, verbose=False)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = launch_counts()
    phases = {k: v for k, v in getattr(trainer, "prelude_log", {}).items() if k.endswith("_s")}
    return dict(valid=valid, fit_s=fit_s, epoch_s=trainer.epoch_times[0], phases=phases, launches=launches,
                held=held_table_bytes(torch, trainer, held_names))


def mesh_family_batch(torch, name, td, mesh) -> dict:
    """One training batch of ``name`` on Amazon-baby (its published YAML)
    split over the data axis: every rank builds the model on ``td``, takes
    global rank 0's parameters and state, draws the same global batch and
    passes the loss the same generator; the gradients are summed over the
    axis. This rank's set-up time and launches in the batch; on global rank
    0 also the loss and gradients against the global batch on this one rank
    with the same draws."""
    from genmmrec_tpu_torch.config import Config
    from genmmrec_tpu_torch.models import get_model
    from genmmrec_tpu_torch.parallel import mesh as pm

    dev = td.users.device
    seeded = lambda k: torch.Generator(device=dev).manual_seed(SEED + k)
    config = Config(name, "baby", {"save_recommended_topk": False})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = get_model(name)(config, td)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    model.init_params(seeded(0))
    state = model.pre_epoch(model.init_state(seeded(1)), seeded(2), 0)
    pm.replicated((list(model.parameters()), state), mesh)
    B = int(config["train_batch_size"])
    g = seeded(51)
    idx = torch.randint(0, td.n_inter, (B,), generator=g, device=dev)
    batch = {"users": td.users[idx], "pos": td.items[idx],
             "neg": torch.randint(0, model.n_items, (B,), generator=g, device=dev),
             "weight": (torch.arange(B, device=dev) < B - 7).to(torch.float32)}
    params = dict(model.named_parameters())
    rows = pm.DataRows(mesh, B)
    out = dict(name=name, setup_s=setup_s, rows=rows.hi - rows.lo)
    with torch.enable_grad():
        reset_counts()
        total, _ = model.loss(state, {**rows.local(batch), "rows": rows}, seeded(52))
        total.backward()
        torch.cuda.synchronize()
        out["launches"] = {k: v for k, v in launch_counts().items() if k in STEP_KERNELS}
        pm.reduce_grads(params.values(), mesh)
        out["loss"] = float(pm.all_reduce(total.detach().clone(), mesh, pm.DATA_AXIS))
        if not mesh.is_main:
            return out
        summed = {k: p.grad.clone() for k, p in params.items()}
        model.zero_grad(set_to_none=True)
        # the magnitudes of each listed linear layer's row terms: of its
        # bias gradient Σ|δ| over the rows, of its weight's |δ|ᵀ|x|, with δ
        # the cotangent of its output and x its input, summed over its calls
        terms = {}

        def keep_terms(layer):
            def hook(module, inputs, output):
                if not output.requires_grad:  # a call without an autograd graph (an RF host's conditions)
                    return
                x = inputs[0].detach().abs().reshape(-1, inputs[0].shape[-1])

                def add(g):
                    g = g.abs().reshape(-1, g.shape[-1])
                    for key, t in ((f"{layer}.bias", g.sum(0)), (f"{layer}.weight", g.T @ x)):
                        terms[key] = terms.get(key, 0) + t

                output.register_hook(add)
            return hook

        hooks = [model.get_submodule(l).register_forward_hook(keep_terms(l)) for l in MESH_ON_TERMS.get(name, ())]
        watched = {id(p): k for k, p in params.items() if re.match(MESH_ON_PROJECTIONS.get(name, "$^"), k)}
        with projection_terms(torch, watched, terms):
            ref, _ = model.loss(state, batch, seeded(52))
            ref.backward()
        for h in hooks:
            h.remove()
    grads = {k: torch.zeros_like(p) if p.grad is None else p.grad for k, p in params.items()}
    zero = {}
    for k in grads:
        for pattern, weight in MESH_ZERO_GRADS.get(name, ()):
            if re.match(pattern, k):
                zero[k] = re.sub(pattern, weight, k)
    share, rel = {}, {}
    for k, r in grads.items():
        if k in zero:
            # zero but for rounding: within MESH_BATCH_GRAD_ATOL of its weight's largest
            scale = grads[zero[k]].abs().max()
            share[k] = (summed[k].abs().max() / (MESH_BATCH_GRAD_ATOL * scale).clamp(min=1e-30)).item()
            rel[k] = (summed[k].abs().max() / scale.clamp(min=1e-30)).item()
            continue
        scale = terms[k] if k in terms else r.abs().max()
        err = (summed[k] - r).abs()
        bound = MESH_BATCH_GRAD_RTOL * r.abs() + (MESH_TERMS_ATOL if k in terms else MESH_BATCH_GRAD_ATOL) * scale
        share[k] = (err / bound.clamp(min=1e-30)).max().item()
        rel[k] = (err / scale.clamp(min=1e-30)).max().item() if scale.max() > 0 else 0.0
    worst = max(share, key=share.get)
    out.update(loss_one_rank=ref.item(), loss_rel=abs(out["loss"] - ref.item()) / max(abs(ref.item()), 1e-30),
               worst_param=worst, worst_share_of_bound=share[worst], largest_rel_err=max(rel.values()),
               n_params=len(params))
    return out


def projection_terms(torch, watched: dict, terms: dict):
    """A function mode that adds to ``terms[name]``, in the backward, the
    magnitudes of the row terms of each parameter of ``watched`` (id ->
    name): |δ|ᵀ|x| for a weight W of a product ``x @ W.T``, Σ|δ| over the
    rows for a bias b of a sum ``y + b`` (δ the cotangent of the result)."""

    class Mode(torch.overrides.TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = getattr(func, "__name__", "")
            if len(args) != 2 or not torch.is_tensor(args[1]) or not torch.is_tensor(out) or not out.requires_grad:
                return out
            if name in ("matmul", "__matmul__") and args[1]._base is not None and id(args[1]._base) in watched:
                key, x = watched[id(args[1]._base)], args[0].detach().abs().reshape(-1, args[0].shape[-1])
                term = lambda g: g.abs().reshape(-1, g.shape[-1]).T @ x
            elif name in ("add", "__add__") and id(args[1]) in watched:
                key, term = watched[id(args[1])], lambda g: g.abs().reshape(-1, g.shape[-1]).sum(0)
            else:
                return out

            def add(g, key=key, term=term):
                terms[key] = terms.get(key, 0) + term(g)

            out.register_hook(add)
            return out

    return Mode()


def mesh_family_rank(torch, dev, mesh, card) -> dict:
    """The checks of the 45 models on one rank of the ``MESH_SHAPE`` world:
    the fits of ``MESH_FITS`` (``mesh_fit_drive``; after MVDiff's, K3 at its
    phase 4's item shard, ``regeneration_shard_k3``), then one batch of each
    model of ``MESH_FAMILY_MODELS`` (``mesh_family_batch``) on MGCN's train
    data."""
    fits, k3 = {}, []
    for name in MESH_FITS:
        t0 = time.perf_counter()
        config, fit_td, vd, model = mesh_fit_setup(torch, dev, name)
        setup_s = time.perf_counter() - t0
        fits[name] = dict(setup_s=setup_s, **mesh_fit_drive(torch, name, config, model, fit_td, vd, mesh))
        if name == "MGCN":
            td = fit_td
        if name == "MVDiff":
            chunk = torch.arange(min(int(config["train_batch_size"]), model.n_users), device=dev)
            k3 += regeneration_shard_k3(torch, model, fit_td, chunk, card, f"mesh_rank{mesh.rank}_MVDiff_phase4")
        del model, vd
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    batches = []
    for name in MESH_FAMILY_MODELS:
        batches.append(mesh_family_batch(torch, name, td, mesh))
        torch.cuda.empty_cache()
    return dict(fits=fits, batches=batches, batches_s=time.perf_counter() - t0, k3_cases=k3)


def regeneration_shard_k3(torch, model, td, users, card, case):
    """K3 against its plain version at the shape the item split's
    regeneration gives it: ``model``'s reverse-diffused interaction vectors
    of ``users`` on this rank's columns (DiffMM's ``p_sample_users``,
    MVDiff's ``sparsity_p_sample``, each modality), top ``rebuild_k``
    (``check_k3``) → its cases."""
    from genmmrec_tpu_torch.data.arrays import interaction_vectors
    from genmmrec_tpu_torch.parallel import mesh as pm

    cols = model.item_cols
    with torch.no_grad(), pm.whole_tables(model):
        x = interaction_vectors(td, users, cols)
        sample = model.p_sample_users if hasattr(model, "p_sample_users") else model.sparsity_p_sample
        planes = [(m, sample(getattr(model, f"denoise_{m}"), x).contiguous()) for m in ("image", "text")]
    k = int(model.rebuild_k)
    return check_k3(torch, [(f"{case}_{m}_items{cols.lo}_{cols.hi}_top{k}", plane, k, None) for m, plane in planes],
                    card)["cases"]


def mesh_rank(dev, card):
    """One rank of the ``MESH_SHAPE`` world: ``mesh_drive``, the batch check,
    K3 on this rank's item shard against its plain version (float32 and
    bfloat16) for the evaluation and for the regeneration of the fit's item
    split (``regeneration_shard_k3``), and the times of the layer's
    collectives. Returns, on global rank 0, every rank's results."""
    import torch
    import torch.distributed as dist

    from genmmrec_tpu_torch.engine.trainer import get_trainer
    from genmmrec_tpu_torch.ops.precision import full_precision_matmuls
    from genmmrec_tpu_torch.parallel import mesh as pm

    full_precision_matmuls()
    torch.set_grad_enabled(False)
    mesh = pm.build_mesh({"mesh_shape": MESH_SHAPE})
    t0 = time.perf_counter()
    config, td, vd, ted, model = mesh_setup(torch, dev)
    setup_s = time.perf_counter() - t0
    make = lambda: get_trainer("DiffMM")(config, model, mesh=mesh)
    trainer, res, times, launches, bf16_launches = mesh_drive(torch, make, model, vd, ted)
    batch = mesh_batch_check(torch, trainer, model, mesh)
    held = held_table_bytes(torch, trainer)
    # K3 on this rank's shard of a 4,096-user chunk, as sharded_topk gives it
    B, k = MESH_TOPK_SHAPE
    lo, hi = pm.shard_bounds(model.n_items, mesh.model)[mesh.model_rank]
    with pm.whole_tables(model):
        u, i = model.eval_artifacts(trainer.state)
    users = vd.users[:B]
    plane = (u[users] @ i[lo:hi].T).contiguous()
    shard_mask = trainer._dense_mask(vd)[:B, lo // 8 : lo // 8 + -(-(hi - lo) // 8)].contiguous()
    k3 = check_k3(torch, [
        (f"mesh_rank{mesh.rank}_items{lo}_{hi}_top{k}", plane, k, shard_mask),
        (f"mesh_rank{mesh.rank}_items{lo}_{hi}_top{k}_bf16", plane.bfloat16(), k, shard_mask),
    ], card)["cases"]
    chunk = torch.arange(min(int(config["train_batch_size"]), model.n_users), device=dev)
    k3 += regeneration_shard_k3(torch, model, td, chunk, card, f"mesh_rank{mesh.rank}_DiffMM_regeneration")

    def timed(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        dist.barrier()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / reps * 1e3

    vals, idx = torch.randn(B, k, device=dev), torch.randint(0, model.n_items, (B, k), device=dev)
    rec = trainer._step_params(["main"])
    for p in rec:
        p.grad = torch.randn_like(p)
    collectives = dict(
        all_gather_topk_ms=timed(lambda: (pm.all_gather(vals[None], mesh, pm.MODEL_AXIS),
                                          pm.all_gather(idx[None], mesh, pm.MODEL_AXIS))),
        reduce_grads_main_ms=timed(lambda: pm.reduce_grads(rec, mesh)),
        main_grad_floats=sum(p.numel() for p in rec),
    )
    for p in rec:
        p.grad = None
    del trainer, model, plane, u, i, rec
    torch.cuda.empty_cache()
    family = mesh_family_rank(torch, dev, mesh, card)
    mine = dict(rank=mesh.rank, device=str(dev), backend=mesh.backend, setup_s=setup_s, results=res, times=times,
                launches=launches, bf16_launches=bf16_launches, k3_cases=k3, collectives=collectives, family=family,
                held=held)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return dict(ranks=every, batch=batch)


def mesh_path(torch, card):
    """The multi-device layer on the one card: ``MESH_SHAPE`` (4 gloo ranks
    through ``parallel.launch.run``) runs ``mesh_rank``; the same seed on
    one rank in this process runs ``mesh_drive``; every metric within
    MESH_METRIC_ATOL. Every rank must launch K1 and K3, and K3 in both
    evaluations (the sharded route; the fused and K4 routes stand aside).
    Then the spectral clustering of fused features (``MultimodalCluster.
    multimodal_fusion_cluster``) at baby on the card against the CPU, and
    DiffMM's item split over the model axis at elec's width
    (``item_split_check``). Returns (summary, kernel cases by kernel,
    launches)."""
    from genmmrec_tpu_torch.engine.trainer import get_trainer
    from genmmrec_tpu_torch.parallel import launch

    phase_t0 = time.perf_counter()
    world = launch.run(mesh_rank, MESH_SHAPE, "cuda", (card,))
    world_s = time.perf_counter() - phase_t0
    ranks = world["ranks"]
    for r in ranks:
        need = [n for n in ("segment_spmm", "segment_spmm_backward", "grouped_topk") if r["launches"][n] <= 0]
        if need or r["bf16_launches"]["grouped_topk"] <= 0 or r["bf16_launches"]["fused_group_max"] > 0:
            raise AssertionError(f"mesh rank {r['rank']}: launches {r['launches']}, bf16 {r['bf16_launches']}")
        print(f"mesh rank {r['rank']} ({r['device']}, {r['backend']}): set-up {r['setup_s']:.1f} s, "
              f"{json.dumps({k: round(v, 3) for k, v in r['times'].items()})}; launches {json.dumps(r['launches'])}; "
              f"collectives {json.dumps(r['collectives'])} [{card}]")
    # the same seed on one rank, in this process
    t0 = time.perf_counter()
    config, td, vd, ted, model = mesh_setup(torch, torch.device("cuda:0"))
    setup_s = time.perf_counter() - t0
    make = lambda: get_trainer("DiffMM")(config, model)
    trainer, one, one_times, one_launches, _ = mesh_drive(torch, make, model, vd, ted)
    # each table held as rows: half of one rank's bytes on every rank
    one_held = held_table_bytes(torch, trainer, sorted(ranks[0]["held"]))
    failures = check_held_halves("DiffMM/baby", [r["held"] for r in ranks], one_held, card)
    if failures:
        raise AssertionError(f"{len(failures)} held-table checks failed: " + " | ".join(failures))
    mesh_res = ranks[0]["results"]
    drift = {f"{split}/{k}": mesh_res[split][k] - one[split][k] for split in one for k in one[split]}
    off = {k: v for k, v in drift.items() if not abs(v) <= MESH_METRIC_ATOL}
    if off:
        raise AssertionError(f"the {MESH_SHAPE} fit strays from one rank's by more than {MESH_METRIC_ATOL}: {off}")
    worst = max(drift.items(), key=lambda kv: abs(kv[1]))
    print(f"mesh {MESH_SHAPE} against one rank: {len(drift)} metrics within {MESH_METRIC_ATOL} (largest "
          f"{worst[0]} {worst[1]:+.5f}); Recall@20 valid {mesh_res['valid_float32']['recall@20']:.4f} / "
          f"{one['valid_float32']['recall@20']:.4f}; one batch {json.dumps(world['batch'])}; wall: world "
          f"{world_s:.1f} s, rank 0's drive {ranks[0]['times']['total_s']:.2f} s (its first, cold, "
          f"{ranks[0]['times']['first_drive_s']:.2f} s), one rank's {one_times['total_s']:.2f} s (first "
          f"{one_times['first_drive_s']:.2f} s) + set-up {setup_s:.1f} s [{card}]")
    del trainer
    torch.cuda.empty_cache()
    family = mesh_family_check(torch, ranks, card)
    # the spectral clustering of fused features, on the card and on the CPU
    fusion = fusion_cluster_check(torch, model.item_raw_features, card)
    del model
    torch.cuda.empty_cache()
    split = item_split_check(torch, card)
    totals = {k: one_launches[k] + fusion["launches"][k] + family["launches"][k] + split["launches"][k]
              + sum(r["launches"][k] for r in ranks) for k in one_launches}
    out = dict(
        mesh_shape=MESH_SHAPE, world_s=world_s,
        ranks=[{k: v for k, v in r.items() if k not in ("k3_cases", "family")} for r in ranks], family=family,
        batch=world["batch"], one_rank=dict(results=one, times=one_times, setup_s=setup_s, launches=one_launches,
                                            held=one_held),
        drift=drift, fusion_cluster={k: v for k, v in fusion.items() if k != "k3_cases"},
        item_split={k: v for k, v in split.items() if k != "k3_cases"},
        phase_s=time.perf_counter() - phase_t0,
    )
    print(f"mesh_path phase done in {out['phase_s']:.1f} s [{card}]")
    k3 = [c for r in ranks for c in r["k3_cases"] + r["family"]["k3_cases"]] + fusion["k3_cases"] + split["k3_cases"]
    return out, dict(k1=[], k1_bwd=[], k3=k3), totals


def mesh_family_check(torch, ranks, card) -> dict:
    """The 45 models' checks of the world's ranks (``mesh_family_rank``):
    each fit of ``MESH_FITS`` on the mesh against the same seed on one rank
    in this process (every valid metric within MESH_METRIC_ATOL, every rank
    launching K1 forward and backward, and K3 for MVDiff's phases 2 and 4);
    each model's batch (the loss within MESH_BATCH_LOSS_RTOL of one rank's,
    every gradient element within MESH_BATCH_GRAD_RTOL of its magnitude
    plus MESH_BATCH_GRAD_ATOL of its tensor's largest (a layer of
    MESH_ON_TERMS within MESH_TERMS_ATOL of its row terms' magnitudes, a
    gradient of MESH_ZERO_GRADS within MESH_BATCH_GRAD_ATOL of its weight's
    largest), each rank launching K1 forward and backward if the model
    propagates and K3 if its step takes a top-k). Returns the summary with
    the launches of all of it."""
    fam = [r["family"] for r in ranks]
    cuda0 = torch.device("cuda:0")
    launches = None
    fits = {}
    # every check is printed before the first failure is raised
    failures = []
    for name in MESH_FITS:
        t0 = time.perf_counter()
        config, td, vd, model = mesh_fit_setup(torch, cuda0, name)
        setup_s = time.perf_counter() - t0
        one = mesh_fit_drive(torch, name, config, model, td, vd, held_names=sorted(fam[0]["fits"][name]["held"]))
        del model, td, vd
        torch.cuda.empty_cache()
        launches = dict(one["launches"]) if launches is None else {k: v + one["launches"][k] for k, v in launches.items()}
        need = ("segment_spmm", "segment_spmm_backward") + (("grouped_topk",) if name == "MVDiff" else ())
        for r, f in enumerate(fam):
            got = f["fits"][name]["launches"]
            if any(got[k] <= 0 for k in need):
                failures.append(f"mesh rank {r}: {name}'s fit launched none of one of {need}: {got}")
            launches = {k: v + got[k] for k, v in launches.items()}
        failures += check_held_halves(f"{name}/baby", [f["fits"][name]["held"] for f in fam], one["held"], card)
        mesh_valid = fam[0]["fits"][name]["valid"]
        drift = {k: mesh_valid[k] - one["valid"][k] for k in one["valid"]}
        off = {k: v for k, v in drift.items() if not abs(v) <= MESH_METRIC_ATOL}
        if off:
            failures.append(f"{name}/baby on {MESH_SHAPE} strays from one rank's by more than {MESH_METRIC_ATOL}: {off}")
        worst = max(drift.items(), key=lambda kv: abs(kv[1]))
        m0 = fam[0]["fits"][name]
        phases = "; ".join(f"{k} {v:.2f} s / {one['phases'][k]:.2f} s" for k, v in m0["phases"].items())
        per_rank = "; ".join(f"rank {r} K1 {f['fits'][name]['launches']['segment_spmm']} + "
                             f"{f['fits'][name]['launches']['segment_spmm_backward']}, K3 "
                             f"{f['fits'][name]['launches']['grouped_topk']}" for r, f in enumerate(fam))
        print(f"{name}/baby (embedding {config['embedding_size']}, batch {config['train_batch_size']}) on {MESH_SHAPE} "
              f"against one rank: {len(drift) - len(off)} of {len(drift)} valid metrics within {MESH_METRIC_ATOL} "
              f"(largest {worst[0]} "
              f"{worst[1]:+.5f}); Recall@20 {mesh_valid['recall@20']:.4f} / {one['valid']['recall@20']:.4f}; wall: "
              f"the world's fit {m0['fit_s']:.2f} s (epoch {m0['epoch_s']:.2f} s, set-up {m0['setup_s']:.1f} s a rank), "
              f"one rank's {one['fit_s']:.2f} s (epoch {one['epoch_s']:.2f} s, set-up {setup_s:.1f} s)"
              + (f"; phases, rank 0 / one rank: {phases}" if phases else "") + f"; launches {per_rank} [{card}]")
        fits[name] = dict(mesh=m0, one_rank=dict(one, setup_s=setup_s), drift=drift)
    lines = []
    for i, name in enumerate(MESH_FAMILY_MODELS):
        per = [f["batches"][i] for f in fam]
        main = per[0]
        if main["name"] != name:
            raise AssertionError(f"mesh batch {i}: rank 0 ran {main['name']}, not {name}")
        need = (() if name in MESH_NO_PROPAGATION else ("segment_spmm", "segment_spmm_backward"))
        need += ("grouped_topk",) if name in MESH_K3_IN_STEP else ()
        for r, b in enumerate(per):
            if any(b["launches"][k] <= 0 for k in need):
                failures.append(f"mesh batch {name}, rank {r}: one of {need} not launched: {b['launches']}")
            launches = {k: v + b["launches"].get(k, 0) for k, v in launches.items()}
        if not main["loss_rel"] <= MESH_BATCH_LOSS_RTOL or not main["worst_share_of_bound"] <= 1.0:
            failures.append(f"mesh batch {name}: loss {main['loss']} against one rank's {main['loss_one_rank']}, "
                            f"gradient {main['worst_param']} at {main['worst_share_of_bound']:.3f} of its bound")
        per_rank = "; ".join(f"rank {r} K1 {b['launches']['segment_spmm']} + {b['launches']['segment_spmm_backward']}, "
                             f"K3 {b['launches']['grouped_topk']}" for r, b in enumerate(per))
        print(f"mesh batch {name} at baby ({main['rows']} of {2 * main['rows']} rows a data rank): loss over the data "
              f"axis {main['loss']:.8g}, one rank {main['loss_one_rank']:.8g} (relative {main['loss_rel']:.2e}); "
              f"{main['n_params']} gradients, largest relative error {main['largest_rel_err']:.2e}, worst element at "
              f"{main['worst_share_of_bound']:.3f} of its bound ({main['worst_param']}); launches {per_rank}; set-up "
              f"{max(b['setup_s'] for b in per):.2f} s (slowest rank) [{card}]")
        lines.append(dict(name=name, loss=main["loss"], loss_one_rank=main["loss_one_rank"], loss_rel=main["loss_rel"],
                          largest_rel_err=main["largest_rel_err"], worst_share_of_bound=main["worst_share_of_bound"],
                          launches=[b["launches"] for b in per], setup_s=[b["setup_s"] for b in per]))
    phase = max(f["batches_s"] for f in fam)
    print(f"mesh batches of {len(MESH_FAMILY_MODELS)} models done in {phase:.1f} s a rank (set-ups included) [{card}]")
    if failures:
        raise AssertionError(f"{len(failures)} mesh checks failed: " + " | ".join(failures))
    return dict(fits=fits, batches=lines, batches_s=phase, launches=launches)


# -- the model axis's item split at elec's width -----------------------------
# DiffMM as published (its YAML: dims [1000], d_emb_size 10, steps 5; the
# overall train_batch_size 2,048) over elec's 63,001 items on {model: 2}: two
# gloo ranks on the card against one rank in this process. The width is not
# cut; the users are, to one phase-1 batch and one regeneration chunk.
ITEM_SPLIT_SHAPE = {"data": 1, "model": 2}
ITEM_SPLIT_USERS = 2048
# a rank's top-1 may differ from one rank's only where one rank's denoised
# values of the two items tie within this share of the row's largest
ITEM_SPLIT_TIE_RTOL = 1e-6


def item_split_setup(torch, dev, dataset="elec", users=ITEM_SPLIT_USERS):
    """DiffMM's config at a dataset tier (elec) with the users cut to
    ``users`` (and the interactions in proportion), its train table by
    ``synthetic_tables``, on ``dev``: (config, train data)."""
    from genmmrec_tpu_torch.config import Config
    from genmmrec_tpu_torch.data.arrays import build_train_data
    from genmmrec_tpu_torch.data.dataset import RecDataset

    full = Config("DiffMM", dataset, {})
    inters = round(int(full["synthetic_n_inters"]) * users / int(full["synthetic_n_users"]))
    config = Config("DiffMM", dataset, {"save_recommended_topk": False, "synthetic_n_users": users,
                                        "synthetic_n_inters": inters, "train_batch_size": users})
    train_ds = RecDataset(config, synthetic_tables(config, SEED)[0])
    return config, build_train_data(train_ds, dev)


def item_split_drive(torch, dev, mesh=None, dataset="elec", users=ITEM_SPLIT_USERS) -> dict:
    """DiffMM at elec's width (``item_split_setup``) from the seed, on
    ``mesh`` (its model axis's item split) or on one rank: one phase-1 batch
    of both denoisers, timed, with this process's peak memory over it; the
    same batch again from the same start with each denoiser's gradient kept
    whole (``dryrun.record_step_grads``, whose gathers stay out of the first
    batch's peak); then one regeneration chunk, timed, its launches counted,
    and each user's top-1 item per modality from the regenerated graphs.
    Each keeps its denoised planes (on the item split this rank's columns,
    on the device, for K3 against its plain version; one rank's on the CPU,
    to hold a rank's top-1 where it differs). ``dataset`` and ``users``
    other than elec's give a dry run of the control flow at a small size on
    the CPU (no memory figures)."""
    from genmmrec_tpu_torch.data.arrays import interaction_vectors
    from genmmrec_tpu_torch.engine.trainer import get_trainer
    from genmmrec_tpu_torch.models import get_model
    from genmmrec_tpu_torch.parallel import dryrun
    from genmmrec_tpu_torch.parallel import mesh as pm

    on_card = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if on_card else (lambda: None)
    memory = (lambda f: f(dev)) if on_card else (lambda f: 0)
    t0 = time.perf_counter()
    config, td = item_split_setup(torch, dev, dataset, users)
    model = get_model("DiffMM")(config, td)
    sync()
    out = dict(setup_s=time.perf_counter() - t0, n_users=td.n_users, n_items=td.n_items,
               batch=int(config["train_batch_size"]))

    def start():
        trainer = get_trainer("DiffMM")(config, model, mesh=mesh)
        model.init_params(torch.Generator(device=dev).manual_seed(SEED))
        trainer.state = model.init_state(trainer.split("state"))
        pm.replicated((list(model.parameters()), trainer.state), mesh)
        trainer._build_train_step(td)
        return trainer, trainer.split("epoch", 0, "prelude")

    trainer, gen = start()
    out["split"] = sorted(k for k, p in model.named_parameters() if isinstance(getattr(p, "held_rows", None),
                                                                              pm.ItemCols))
    sync()
    memory(torch.cuda.reset_peak_memory_stats)
    before = memory(torch.cuda.memory_allocated)
    t0 = time.perf_counter()
    trainer._diffusion_epoch(gen)
    sync()
    out.update(phase1_s=time.perf_counter() - t0, allocated_before=before, peak=memory(torch.cuda.max_memory_allocated))
    out["peak_rise"] = out["peak"] - before
    trainer, gen = start()
    grads = dryrun.record_step_grads(trainer)
    out["losses"] = trainer._diffusion_epoch(gen)[0].cpu().tolist()
    out["grads"] = grads
    reset_counts()
    sync()
    t0 = time.perf_counter()
    state = trainer.regenerate(gen)
    sync()
    out.update(regenerate_s=time.perf_counter() - t0, launches=launch_counts())
    top = {}
    for m in ("image", "text"):
        g = state[f"{m}_ui"]
        to_item = (g.rows < td.n_users) & (g.cols >= td.n_users)
        order = torch.argsort(g.rows[to_item])
        top[m] = (g.cols[to_item][order] - td.n_users).cpu()
    out["top1"] = top
    with torch.no_grad():
        x = interaction_vectors(td, torch.arange(td.n_users, device=dev), model.item_cols)
        out["denoised"] = {m: model.p_sample_users(getattr(model, f"denoise_{m}"), x) for m in top}
    if mesh is None:
        out["denoised"] = {m: v.cpu() for m, v in out["denoised"].items()}
    else:
        out["rebuild_k"] = int(model.rebuild_k)
    return out


def item_split_rank(dev, card, dataset="elec", users=ITEM_SPLIT_USERS):
    """One rank of the ``ITEM_SPLIT_SHAPE`` world: ``item_split_drive`` on
    the item split, then K3 against its plain version on this rank's
    denoised columns at the regeneration's ``rebuild_k`` (``check_k3``; on
    the card), and the time of the in-projection gradient's gather over the
    model axis. Returns every rank's results on global rank 0, with rank
    0's gradients."""
    import torch
    import torch.distributed as dist

    from genmmrec_tpu_torch.ops.precision import full_precision_matmuls
    from genmmrec_tpu_torch.parallel import mesh as pm

    full_precision_matmuls()
    mesh = pm.build_mesh({"mesh_shape": ITEM_SPLIT_SHAPE})
    mine = item_split_drive(torch, dev, mesh, dataset, users)
    grads = mine.pop("grads")
    denoised, k = mine.pop("denoised"), mine.pop("rebuild_k")
    cols = pm.ItemCols(mesh, mine["n_items"])
    mine.update(rank=mesh.rank, cols=(cols.lo, cols.hi))
    mine["k3_cases"] = [] if dev.type != "cuda" else check_k3(torch, [
        (f"item_split_rank{mesh.rank}_{m}_items{cols.lo}_{cols.hi}_top{k}", plane.contiguous(), k, None)
        for m, plane in denoised.items()
    ], card)["cases"]
    del denoised
    # the gather over the model axis that the in-projection's gradient takes once a denoiser
    w_in = next(v for k, v in grads.items() if k.endswith("in_layers.0.weight"))
    g = torch.zeros(w_in.shape[0], cols.width, device=dev)
    cols.gather(g, 1)
    reps = 3
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        cols.gather(g, 1)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    mine["in_grad_gather_ms"] = (time.perf_counter() - t0) / reps * 1e3
    mine["in_grad_bytes"] = w_in.shape[0] * cols.n * 4
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return dict(ranks=every, grads=grads)


def item_split_check(torch, card, dev="cuda", dataset="elec", users=ITEM_SPLIT_USERS) -> dict:
    """``item_split_rank`` on a world of ``ITEM_SPLIT_SHAPE`` against
    ``item_split_drive`` on one rank in this process: the phase-1 batch's
    losses within MESH_BATCH_LOSS_RTOL, every denoiser gradient element
    within MESH_BATCH_GRAD_RTOL of its magnitude plus MESH_BATCH_GRAD_ATOL
    of its tensor's largest, each user's regenerated top-1 equal to one
    rank's (or, where not, one rank's denoised values of the two items tied
    within ITEM_SPLIT_TIE_RTOL of the row's largest), every rank launching
    K3 on its shard; each rank's peak memory over the batch beside one
    rank's. ``dev``, ``dataset`` and ``users`` give a dry run on the CPU
    (``item_split_drive``), where the launch check is skipped."""
    from genmmrec_tpu_torch.parallel import launch

    t0 = time.perf_counter()
    world = launch.run(item_split_rank, ITEM_SPLIT_SHAPE, dev, (card, dataset, users))
    world_s = time.perf_counter() - t0
    one = item_split_drive(torch, torch.device("cuda:0" if dev == "cuda" else dev), None, dataset, users)
    ranks, got = world["ranks"], world["grads"]
    failures = []
    for r in ranks[1:]:
        if r["losses"] != ranks[0]["losses"] or any(not torch.equal(r["top1"][m], t) for m, t in ranks[0]["top1"].items()):
            failures.append(f"rank {r['rank']}'s losses or merged top-1 differ from rank 0's")
    loss_rel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(ranks[0]["losses"], one["losses"]))
    if not loss_rel <= MESH_BATCH_LOSS_RTOL:
        failures.append(f"losses {ranks[0]['losses']} against one rank's {one['losses']}")
    worst, worst_k = 0.0, None
    if got.keys() != one["grads"].keys():
        failures.append(f"gradients of {sorted(got)} against one rank's {sorted(one['grads'])}")
    for k, r in one["grads"].items():
        r_t, g_t = torch.as_tensor(r), torch.as_tensor(got.get(k, r * 0))
        bound = MESH_BATCH_GRAD_RTOL * r_t.abs() + MESH_BATCH_GRAD_ATOL * r_t.abs().max()
        share = ((g_t - r_t).abs() / bound.clamp(min=1e-30)).max().item()
        if share > worst:
            worst, worst_k = share, k
    if worst > 1.0:
        failures.append(f"gradient {worst_k} at {worst:.3f} of its bound")
    ties = {}
    for m, ref in one["top1"].items():
        mine = ranks[0]["top1"][m]
        off = (mine != ref).nonzero().flatten()
        den = one["denoised"][m]
        if len(off):
            gap = (den[off, mine[off]] - den[off, ref[off]]).abs() / den[off].abs().max(dim=1).values
            if not (gap <= ITEM_SPLIT_TIE_RTOL).all():
                failures.append(f"{m}: {len(off)} users' top-1 differ, not tied: {gap.max().item():.2e}")
        ties[m] = int(len(off))
    for r in ranks:
        if dev == "cuda" and r["launches"]["grouped_topk"] <= 0:
            failures.append(f"rank {r['rank']} launched no K3 in the regeneration: {r['launches']}")
        if r["split"] != ranks[0]["split"] or not r["split"]:
            failures.append(f"rank {r['rank']} holds {r['split']} as its rows")
    draw = one["batch"] * one["n_items"] * (4 + 1)
    mib = lambda b: b / 2**20
    for r in ranks:
        print(f"item split rank {r['rank']} of {ITEM_SPLIT_SHAPE} (items {r['cols'][0]}-{r['cols'][1]} of "
              f"{r['n_items']}): phase-1 batch {r['phase1_s']:.3f} s, peak {mib(r['peak']):.1f} MiB (rise "
              f"{mib(r['peak_rise']):.1f} MiB over {mib(r['allocated_before']):.1f} MiB); regeneration chunk "
              f"{r['regenerate_s']:.3f} s, K3 launches {r['launches']['grouped_topk']}; the in-projection gradient's "
              f"gather over the axis ({mib(r['in_grad_bytes']):.1f} MiB whole) {r['in_grad_gather_ms']:.1f} ms; set-up "
              f"{r['setup_s']:.1f} s [{card}]")
    print(f"item split one rank: phase-1 batch {one['phase1_s']:.3f} s, peak {mib(one['peak']):.1f} MiB (rise "
          f"{mib(one['peak_rise']):.1f} MiB over {mib(one['allocated_before']):.1f} MiB); regeneration chunk "
          f"{one['regenerate_s']:.3f} s, K3 launches {one['launches']['grouped_topk']}; the global noise and keep "
          f"draws each rank makes and slices: {mib(draw):.1f} MiB [{card}]")
    print(f"item split DiffMM/elec width ({one['n_users']} users x {one['n_items']} items, batch {one['batch']}) on "
          f"{ITEM_SPLIT_SHAPE} against one rank: losses {ranks[0]['losses']} / {one['losses']} (relative "
          f"{loss_rel:.2e}); {len(one['grads'])} denoiser gradients, worst element at {worst:.3f} of its bound "
          f"({worst_k}); top-1 equal but for {ties} tied users; held as rows: {ranks[0]['split']}; world "
          f"{world_s:.1f} s [{card}]")
    if failures:
        raise AssertionError(f"{len(failures)} item split checks failed: " + " | ".join(failures))
    strip = lambda d: {k: v for k, v in d.items() if k not in ("grads", "top1", "denoised", "k3_cases")}
    totals = {k: one["launches"][k] + sum(r["launches"][k] for r in ranks) for k in one["launches"]}
    return dict(ranks=[strip(r) for r in ranks], one_rank=strip(one), loss_rel=loss_rel, worst_share_of_bound=worst,
                worst_grad=worst_k, tied_top1=ties, draw_bytes=draw, world_s=world_s, launches=totals,
                k3_cases=[c for r in ranks for c in r["k3_cases"]])


def fusion_cluster_check(torch, feats, card, k: int = 20):
    """``MultimodalCluster.multimodal_fusion_cluster`` of ``feats`` (``k``
    clusters, ``sim_top_k`` 20) on the card, timed, and its steps on the
    card and on the CPU: the sparsified affinity (K3 on the card, the plain
    top-k on the CPU) with the same kept columns in at least 99.9% of the
    rows, K3 on the similarity against its plain version, the spectral
    embeddings spanning the same subspace (every cosine of the principal
    angles at least 0.999), and the two labelings' k-means inertia on the
    CPU's embedding within 10% of each other. The two devices' generators
    draw other k-means seedings, so the labels themselves may differ on
    features without clusters: their adjusted Rand index is reported."""
    from genmmrec_tpu_torch.common.interest_cluster import MultimodalCluster, kmeans_fit, spectral_embedding

    mc = MultimodalCluster(spectral_cluster_num=k, sim_top_k=20)
    before = launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mc.multimodal_fusion_cluster(feats)
    torch.cuda.synchronize()
    function_s = time.perf_counter() - t0

    def steps(f):
        aff = mc.fusion_affinity(f)
        emb = spectral_embedding(aff, k)
        return aff != 0, emb, kmeans_fit(emb, k, n_init=10, seed=mc.seed)[0]

    t0 = time.perf_counter()
    kept, emb, labels = steps(feats)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = {k: v - before[k] for k, v in launch_counts().items()}
    t0 = time.perf_counter()
    kept_cpu, emb_cpu, labels_cpu = steps(feats.cpu())
    cpu_s = time.perf_counter() - t0
    rows_equal = (kept.cpu() == kept_cpu).all(dim=1).double().mean().item()
    cosines = torch.linalg.svdvals(torch.linalg.qr(emb.cpu())[0].T @ torch.linalg.qr(emb_cpu)[0])
    x = emb_cpu.float()

    def inertia(lab):
        lab = lab.cpu()
        sums = torch.zeros(k, x.shape[1]).index_add_(0, lab, x)
        centers = sums / torch.bincount(lab, minlength=k).clamp(min=1)[:, None]
        return ((x - centers[lab]) ** 2).sum().item()

    ratio = inertia(labels) / inertia(labels_cpu)
    agree = adjusted_rand(labels.cpu(), labels_cpu)
    sim = (lambda f: f @ f.T)(torch.nn.functional.normalize(feats.double(), dim=1).float())
    k3 = check_k3(torch, [("fusion_similarity_top20", sim, 20, None)], card)["cases"]
    del sim
    if rows_equal < 0.999 or cosines.min().item() < 0.999 or not 1 / 1.1 <= ratio <= 1.1:
        raise AssertionError(f"fusion cluster: affinity rows equal {rows_equal:.5f}, embedding cosines down to "
                             f"{cosines.min().item():.6f}, inertia ratio {ratio:.4f}")
    print(f"fusion cluster ({feats.shape[0]} items, {feats.shape[1]} features, sim_top_k 20, {k} clusters): the "
          f"function on the card {function_s:.2f} s; its steps on the card {card_s:.2f} s, on the CPU {cpu_s:.2f} s; "
          f"affinity rows equal {rows_equal:.5f}, embedding subspace cosines >= {cosines.min().item():.9f}, "
          f"inertia card/CPU {ratio:.4f}, labels adjusted Rand {agree:.4f}, sizes on the card "
          f"{torch.bincount(labels).tolist()} [{card}]")
    return dict(function_s=function_s, card_s=card_s, cpu_s=cpu_s, rows_equal=rows_equal,
                min_subspace_cosine=cosines.min().item(), inertia_ratio=ratio, adjusted_rand=agree, k3_cases=k3,
                launches=launches)


def adjusted_rand(a, b) -> float:
    """The adjusted Rand index of two labelings (sklearn's formula)."""
    import torch

    a, b = a.long(), b.long()
    n = a.numel()
    table = torch.zeros(int(a.max()) + 1, int(b.max()) + 1, dtype=torch.float64)
    table.index_put_((a, b), torch.ones(n, dtype=torch.float64), accumulate=True)
    comb = lambda x: (x * (x - 1) / 2).sum()
    index, rows, cols = comb(table), comb(table.sum(1)), comb(table.sum(0))
    expected = rows * cols / (n * (n - 1) / 2)
    top = (rows + cols) / 2
    return 1.0 if top == expected else float((index - expected) / (top - expected))


# -- the host tools: raw ratings → the preprocessing CLI → DualGNN/baby ----
# the raw ratings' noise around the core, in rows: users with one row (gone
# in the 5-core's first round), items with one row, users of four core items
# and one item of their own (gone in the second round), exact repeats of
# core rows, repeated (user, item) pairs with another rating and time after
# the row they repeat, and rows with a blank timestamp
PREP_ONE_OFF_USERS = 150_000
PREP_ONE_OFF_ITEMS = 100_000
PREP_ROUND_TWO_USERS = 20_000
PREP_EXACT_REPEATS = 60_000
PREP_PAIR_REPEATS = 60_000
PREP_BLANK_TIMES = 500
PREP_UNMAPPED_ASINS = 500
# the users of the user graph built on both devices for its check
PREP_CHECK_USERS = 2048
PREP_TOP_K = 200


def prep_raw_files(np, root, seed, dataset="baby"):
    """The raw ratings CSV (``user,item,rating,ts``, no header, as Amazon's
    dumps) and a gzipped meta file of Python-dict lines, from the synthetic
    table of a dataset tier (its generator, at the tier's sizes) topped up
    so that every user and item has at least 5 rows (the core), and noise
    around it (``PREP_*``). Returns (ratings path, meta path, the core rows
    as a set of (user, asin, rating, time), summary)."""
    from genmmrec_tpu_torch.config import Config
    from genmmrec_tpu_torch.data.dataset import RecDataset

    t0 = time.perf_counter()
    empty = os.path.join(root, "none")
    os.makedirs(empty, exist_ok=True)
    ds = RecDataset(Config("DualGNN", dataset, {"data_path": empty}))
    generate_s = time.perf_counter() - t0
    n_users, n_items = ds.user_num, ds.item_num
    rng = np.random.default_rng(seed)
    pairs = np.unique(np.stack([ds.table.users, ds.table.items], 1).astype(np.int64), axis=0)
    have = [set() for _ in range(n_users)]
    for u, i in pairs.tolist():
        have[u].add(i)
    for u in range(n_users):  # every user at least 5 items
        while len(have[u]) < 5:
            have[u].add(int(rng.integers(n_items)))
    users_of = [[] for _ in range(n_items)]
    for u in range(n_users):
        for i in have[u]:
            users_of[i].append(u)
    for i in range(n_items):  # every item at least 5 users
        while len(users_of[i]) < 5:
            u = int(rng.integers(n_users))
            if i not in have[u]:
                have[u].add(i)
                users_of[i].append(u)
    cu = np.fromiter((u for u in range(n_users) for _ in have[u]), np.int64)
    ci = np.fromiter((i for u in range(n_users) for i in sorted(have[u])), np.int64)
    n_core = len(cu)
    uname = np.array([f"A{u:013d}X" for u in range(n_users)], dtype=object)
    iname = np.array([f"B{i:09d}" for i in range(n_items)], dtype=object)
    rating = rng.integers(1, 6, n_core).astype(np.float64)
    ts = 1_300_000_000 + rng.integers(0, 100_000_000, n_core)
    rows = [list(zip(uname[cu], iname[ci], rating.tolist(), ts.tolist()))]
    core = set(rows[0])
    new_ts = lambda n: (1_300_000_000 + rng.integers(0, 100_000_000, n)).tolist()
    new_r = lambda n: rng.integers(1, 6, n).astype(np.float64).tolist()
    n = PREP_ONE_OFF_USERS
    rows.append(list(zip((f"AX{j:012d}" for j in range(n)), iname[rng.integers(0, n_items, n)], new_r(n), new_ts(n))))
    n = PREP_ONE_OFF_ITEMS
    rows.append(list(zip(uname[rng.integers(0, n_users, n)], (f"BN{j:08d}" for j in range(n)), new_r(n), new_ts(n))))
    n = PREP_ROUND_TWO_USERS
    r2 = []
    for j in range(n):
        name = f"AR{j:012d}"
        r2 += [(name, iname[i], 4.0, 1_350_000_000 + j) for i in rng.choice(n_items, 4, replace=False)]
        r2.append((name, f"BR{j:08d}", 5.0, 1_350_000_000 + j))
    rows.append(r2)
    n = PREP_BLANK_TIMES
    src = rng.integers(0, n_core, n)
    rows.append([(uname[cu[s]], iname[ci[s]], 3.0, None) for s in src.tolist()])
    base = [r for part in rows for r in part]
    order = rng.permutation(len(base))
    key = np.empty(len(base))
    key[order] = np.arange(len(base), dtype=np.float64)
    # the repeats, each after the core row it repeats
    src = rng.integers(0, n_core, PREP_EXACT_REPEATS + PREP_PAIR_REPEATS)
    after = key[src] + rng.random(len(src)) * (len(base) - key[src])
    reps = [base[s] for s in src[:PREP_EXACT_REPEATS].tolist()]
    m = PREP_PAIR_REPEATS
    reps += list(zip(uname[cu[src[-m:]]], iname[ci[src[-m:]]], new_r(m), new_ts(m)))
    allrows = base + reps
    allkey = np.concatenate([key, after])
    fmt = lambda r: f"{r[0]},{r[1]},{r[2]},{'' if r[3] is None else r[3]}"
    ratings_csv = os.path.join(root, f"ratings_{dataset}.csv")
    with open(ratings_csv, "w") as f:
        f.write("\n".join(fmt(allrows[j]) for j in np.argsort(allkey, kind="stable").tolist()) + "\n")
    meta = os.path.join(root, f"meta_{dataset}.json.gz")
    import gzip

    with gzip.open(meta, "wt") as f:
        names = list(iname) + [f"BU{j:08d}" for j in range(PREP_UNMAPPED_ASINS)]
        for j in rng.permutation(len(names)).tolist():
            rec = {"asin": names[j]}
            if j % 9:
                rec["title"] = "" if j % 13 == 0 else f"{dataset} item {j} soft {j % 17}"
            if j % 4:
                rec["brand"] = f"brand{j % 97}"
            if j % 6:
                rec["categories"] = [[dataset.capitalize(), f"Sub{j % 23}", f"Leaf{j % 5}"], ["Other"]]
            if j % 5:
                rec["description"] = "" if j % 11 == 0 else f"a description of {j}\nwith words {j % 31}"
            f.write(repr(rec) + "\n")
    summary = dict(
        raw_rows=len(allrows), core_rows=n_core, core_users=n_users, core_items=n_items,
        noise_rows=len(allrows) - n_core, generate_s=generate_s, write_s=time.perf_counter() - t0,
    )
    return ratings_csv, meta, core, summary


def plain_kcore(path, min_u=5, min_i=5):
    """A plain k-core of a raw ratings CSV: rows with a blank user, item or
    time go, then exact (user, item, time) repeats, then repeated (user,
    item) pairs (the first stays), then users and items below the floor,
    counted in dicts, until none is left. Returns the kept rows as a set of
    (user, item, rating, time) with numbers as floats."""
    rows, seen_uit, seen_ui = [], set(), set()
    with open(path) as f:
        for line in f:
            u, i, r, t = line.rstrip("\n").split(",")
            if not (u and i and t) or (u, i, t) in seen_uit:
                continue
            seen_uit.add((u, i, t))
            if (u, i) in seen_ui:
                continue
            seen_ui.add((u, i))
            rows.append((u, i, float(r), float(t)))
    while True:
        cu, ci = {}, {}
        for u, i, _, _ in rows:
            cu[u] = cu.get(u, 0) + 1
            ci[i] = ci.get(i, 0) + 1
        kept = [x for x in rows if cu[x[0]] >= min_u and ci[x[1]] >= min_i]
        if len(kept) == len(rows):
            return set(kept)
        rows = kept


def check_prep_kcore(d, dataset, ratings, core, raw):
    """The 5-core that ``rating2inter`` wrote under ``d``: exactly the core's
    users, items and rows (``prep_raw_files``' ``core`` and summary ``raw``),
    equal to a plain k-core of the raw ratings (in dicts, timed), and the
    time column float, as pandas reads it where blank times were dropped.
    Returns its users, items, rows and the plain k-core's seconds."""
    from genmmrec_tpu_torch.preprocessing import pipeline

    inter = pipeline.read_table(f"{d}/{dataset}-indexed.inter", "\t")
    names_u = pipeline.read_table(f"{d}/u_id_mapping.csv", "\t")["user_id"]
    names_i = pipeline.read_table(f"{d}/i_id_mapping.csv", "\t")["asin"]
    kept = set(zip(names_u[inter["userID"]].tolist(), names_i[inter["itemID"]].tolist(),
                   inter["rating"].astype(float).tolist(), inter["timestamp"].astype(float).tolist()))
    n_u, n_i = len(names_u), len(names_i)
    core_f = {(u, i, float(r), float(t)) for u, i, r, t in core}
    if (n_u, n_i) != (raw["core_users"], raw["core_items"]) or kept != core_f:
        raise AssertionError(f"the 5-core kept {n_u} users, {n_i} items, {len(kept)} rows; the core has "
                             f"{raw['core_users']}, {raw['core_items']}, {len(core_f)}")
    t0 = time.perf_counter()
    plain = plain_kcore(ratings)
    plain_s = time.perf_counter() - t0
    if plain != kept:
        raise AssertionError(f"the 5-core's {len(kept)} rows differ from the plain k-core's {len(plain)}")
    with open(f"{d}/{dataset}-indexed.inter") as f:
        next(f)
        if not next(f).rstrip("\n").split("\t")[3].endswith(".0"):
            raise AssertionError("the blank timestamps did not make the time column float, as pandas reads it")
    return dict(users=n_u, items=n_i, rows=len(kept), plain_kcore_s=plain_s)


def check_prep_readers(np, path):
    """The ``.inter`` at ``path`` read back by the native parser and by
    ``_read_inter_csv``: tables, labels and times equal, the times in step
    with the file's column, both timed (host). Returns (the native parser's
    columns, its rows and both seconds)."""
    from genmmrec_tpu_torch import native
    from genmmrec_tpu_torch.data.dataset import _read_inter_csv
    from genmmrec_tpu_torch.preprocessing import pipeline

    cols = (open(path).readline().rstrip("\n").split("\t"), "userID", "itemID", "x_label", "rating", "timestamp")
    t0 = time.perf_counter()
    nat = native.parse_inter_tsv(path, *cols)
    nat_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cs = _read_inter_csv(path, "\t", *cols)
    csv_s = time.perf_counter() - t0
    for f, a, b in zip(("users", "items", "labels", "ratings", "times"), nat, cs):
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f".inter readers: {f} differ")
    if not np.array_equal(nat[4], pipeline.read_table(path, "\t")["timestamp"]):
        raise AssertionError(".inter readers: the times are out of step with the rows")
    return nat, dict(rows=len(nat[0]), native_s=nat_s, csv_s=csv_s)


def cooccurrence_block(torch, users, items, n_users, n_items, lo, dev, repeats):
    """The co-occurrence counts of users [lo, lo + USER_GRAPH_BLOCK) against
    every user, as ``ops/graph.py`` ``cooccurrence_topk`` builds them: the
    0/1 user-item matrix, sparse, times the block's dense rows (their 0/1
    rows, or with ``repeats`` each (user, item) row's count), the diagonal
    zeroed."""
    from genmmrec_tpu_torch.ops.graph import USER_GRAPH_BLOCK

    u = torch.as_tensor(users, device=dev).long()
    i = torch.as_tensor(items, device=dev).long()
    pairs = torch.unique(u * n_items + i)
    r = torch.sparse_coo_tensor(torch.stack([pairs // n_items, pairs % n_items]), torch.ones(len(pairs), device=dev),
                                (n_users, n_items), is_coalesced=True, check_invariants=True)
    hi = min(lo + USER_GRAPH_BLOCK, n_users)
    sel = (u >= lo) & (u < hi)
    left_t = torch.zeros(n_items, hi - lo, device=dev)
    left_t.index_put_((i[sel], u[sel] - lo), torch.ones(int(sel.sum()), device=dev), accumulate=repeats)
    block = (r @ left_t).T.contiguous()
    rows = torch.arange(hi - lo, device=dev)
    block[rows, rows + lo] = 0.0
    return block


def check_prep_user_graph(torch, np, graph, users, items, n_users, n_items, card, case="uu_graph_cooccurrence_top200"):
    """The user graph file against the port's build on both devices over the
    first PREP_CHECK_USERS users' train rows (sorted counts and the
    neighbours above each row's least count equal), against scipy's ``M @
    Bᵀ`` (M the (user, item) rows with multiplicity, B their 0/1 matrix) for
    every user, and K3 on one (PREP_CHECK_USERS, n_users) block of counts at
    k = PREP_TOP_K against its plain version."""
    import scipy.sparse as sp

    from genmmrec_tpu_torch.ops.graph import cooccurrence_topk
    from genmmrec_tpu_torch.preprocessing import user_graph_dict

    def sorted_strict(d):
        ws, strict = [], []
        for u in range(len(d)):
            n, w = d[u]
            ws.append(sorted(w, reverse=True))
            strict.append(frozenset(a for a, b in zip(n, w) if b > min(w, default=0.0)))
        return ws, strict

    sel = users < PREP_CHECK_USERS
    sub = [user_graph_dict(users[sel], items[sel], PREP_CHECK_USERS, n_items, PREP_TOP_K, dev) for dev in ("cuda", "cpu")]
    if sorted_strict(sub[0]) != sorted_strict(sub[1]):
        raise AssertionError("uu-graph: the card's build on a subset differs from the CPU's")
    m = sp.csr_matrix((np.ones(len(users), np.float32), (users, items)), shape=(n_users, n_items))
    m.sum_duplicates()
    b = m.copy()
    b.data[:] = 1.0
    co = (m @ b.T).tocsr()
    co.setdiag(0)
    co.eliminate_zeros()
    got_w, got_s = sorted_strict(graph)
    bad = 0
    for u in range(n_users):
        cnt, nb = co.data[co.indptr[u] : co.indptr[u + 1]], co.indices[co.indptr[u] : co.indptr[u + 1]]
        top = (-np.sort(-cnt)[:PREP_TOP_K]).tolist()
        cut = top[-1] if len(top) else 0
        if got_w[u] != top or got_s[u] != frozenset(nb[cnt > cut].tolist()):
            bad += 1
    if bad:
        raise AssertionError(f"uu-graph: {bad} users' lists differ from scipy's counts")
    full = sum(len(w) == PREP_TOP_K for w in got_w)
    rt = torch.zeros(n_users, n_items, device="cuda")
    u_t, i_t = torch.as_tensor(users, device="cuda"), torch.as_tensor(items, device="cuda")
    rt[u_t, i_t] = 1.0
    left = torch.zeros(PREP_CHECK_USERS, n_items, device="cuda")
    s = u_t < PREP_CHECK_USERS
    left.index_put_((u_t[s], i_t[s]), torch.ones(int(s.sum()), device="cuda"), accumulate=True)
    block = left @ rt.T
    rows = torch.arange(PREP_CHECK_USERS, device="cuda")
    block[rows, rows] = 0.0
    k3 = check_k3(torch, [(case, block, PREP_TOP_K, None)], card)["cases"]
    # the whole build on the card (its blocks' sparse products and K3), and
    # one block's product as a dense GEMM of the 0/1 matrix, for scale
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cooccurrence_topk(users, items, n_users, n_items, PREP_TOP_K, "cuda", repeats=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    dense_ms = cuda_ms(torch, lambda: left @ rt.T, iters=5, warmup=1)
    print(
        f"uu-graph ({n_users} users, top-{PREP_TOP_K}): against the CPU's build on {PREP_CHECK_USERS} users and scipy's "
        f"counts on all: sorted counts and strict sets equal ({full} full rows); cooccurrence_topk on the card "
        f"{build_s:.4f} s (host, synchronized); one block as a dense f32 GEMM {dense_ms:.3f} ms [{card}]"
    )
    return dict(full_rows=full, users=n_users, cooccurrence_topk_s=build_s, dense_block_gemm_ms=dense_ms), k3


def check_prep_model_graph(torch, np, model, train_ds, card):
    """DualGNN's user graph, read from ``user_graph_dict.npy``, against
    ``build_user_graph`` from ``cooccurrence_topk`` on the same train rows:
    on each user with at least k neighbours the sorted weights within 1e-6
    and the strict sets equal; a user with fewer has them cycled from the
    file (no zero weight), and the same set of neighbours."""
    from genmmrec_tpu_torch.models.dualgnn import build_user_graph
    from genmmrec_tpu_torch.ops.graph import unique_ui_pairs

    users, items = unique_ui_pairs(train_ds.table.users, train_ds.table.items)
    k = model.k
    config = _ConfigView(model.config, {"user_graph_dict_file": "no_such_file.npy"})
    built = build_user_graph(config, users, items, model.n_users, model.n_items, k, "cuda")
    as_rows = lambda g: (g.cols.cpu().numpy().reshape(-1, k), g.vals.cpu().numpy().reshape(-1, k))
    (fn, fw), (bn, bw) = as_rows(model.user_graph), as_rows(built)
    full = (bw > 0).all(1)
    (fws, fs), (bws, bs) = (_sorted_and_strict(np, n[full], w[full]) for n, w in ((fn, fw), (bn, bw)))
    err = float(np.abs(fws - bws).max()) if full.any() else 0.0
    if err > 1e-6 or fs != bs:
        raise AssertionError(f"DualGNN's file graph differs from cooccurrence_topk's on full rows ({err:.3e})")
    short = np.flatnonzero(~full & (bw > 0).any(1))
    for u in short.tolist():
        if not (fw[u] > 0).all() or set(fn[u].tolist()) != set(bn[u][bw[u] > 0].tolist()):
            raise AssertionError(f"DualGNN's file graph: user {u} of fewer than {k} neighbours differs")
    print(
        f"DualGNN user graph read from user_graph_dict.npy: {int(full.sum())} full rows equal to cooccurrence_topk's "
        f"(sorted weights within {err:.1e}, strict sets equal), {len(short)} shorter rows cycled from the file with "
        f"the same neighbours [{card}]"
    )
    return dict(full_rows=int(full.sum()), short_rows=len(short), max_abs_err=err)


class _ConfigView:
    """A config with some keys overridden, for a build that must not read a file."""

    def __init__(self, config, over):
        self.config, self.over = config, over

    def __getitem__(self, key):
        return self.over[key] if key in self.over else self.config[key]


def check_data_utils(torch, card):
    """``ImageResize`` of a batch of 0–255 images on the card against the
    CPU (shrunk and enlarged, within 1e-4 of the range; both against a
    float64 resize) and ``mask_batch_text_tokens`` on a
    (256, 128) batch from a card generator: the share selected within 4σ of
    15%, the [MASK] / random / kept split within 4σ of 80/10/10, labels -100
    exactly off the selection, special tokens never selected."""
    import torch.nn.functional as F

    from genmmrec_tpu_torch.data import data_utils as du

    gen = torch.Generator(device="cuda").manual_seed(SEED + 18)
    # 8-bit images on the 0–255 scale; the two devices' float32 rounding
    # grows with the values, so the limit is relative to the range: 1e-4 of
    # it, 0.0255 (an H100 read 3.4e-3 when enlarging, 1.3e-5 of the range; a
    # missing antialias when shrinking is about 100)
    imgs = torch.randint(0, 256, (16, 3, 240, 180), generator=gen, device="cuda").float()
    limit = 1e-4 * 255
    err, err64 = {}, {}
    for size in (112, 400):
        card_out = du.ImageResize(size)(imgs)
        cpu_out = du.ImageResize(size)(imgs.cpu())
        exact = F.interpolate(imgs.cpu().double(), size=tuple(card_out.shape[-2:]), mode="bilinear",
                              align_corners=False, antialias=True)
        err[size] = float((card_out.cpu() - cpu_out).abs().max())
        err64[size] = (float((card_out.cpu().double() - exact).abs().max()), float((cpu_out.double() - exact).abs().max()))
        if err[size] > limit or card_out.device.type != "cuda":
            raise AssertionError(f"ImageResize({size}) on the card differs from the CPU by {err[size]:.3e}")
    b, s, mask_id, vocab = 256, 128, 103, 30522
    inputs = torch.randint(1000, 2000, (b, s), generator=gen, device="cuda")
    special = torch.zeros_like(inputs)
    special[:, 0] = special[:, -1] = 1
    out, lab = du.mask_batch_text_tokens(inputs, mask_id, vocab, gen, special)
    sel = lab != -100
    n, m = b * (s - 2), int(sel.sum())
    p = m / n
    masked = float((out[sel] == mask_id).float().mean())
    kept = float((out[sel] == inputs[sel]).float().mean())
    ok = (
        abs(p - 0.15) < 4 * (0.15 * 0.85 / n) ** 0.5
        and abs(masked - 0.8) < 4 * (0.16 / m) ** 0.5
        and abs(kept - 0.1) < 4 * (0.09 / m) ** 0.5 + 1.0 / vocab
        and torch.equal(lab[sel], inputs[sel]) and torch.equal(out[~sel], inputs[~sel])
        and not sel[:, 0].any() and not sel[:, -1].any()
    )
    if not ok:
        raise AssertionError(f"mask_batch_text_tokens: share {p:.4f}, [MASK] {masked:.4f}, kept {kept:.4f}")
    print(
        f"data_utils on the card: ImageResize of {tuple(imgs.shape)} in 0–255 to 112 and 400 against the CPU "
        f"within {err[112]:.1e} and {err[400]:.1e} (limit {limit:.4f}) (card, CPU against float64: {err64[112][0]:.1e}, "
        f"{err64[112][1]:.1e}; {err64[400][0]:.1e}, {err64[400][1]:.1e}); mask_batch_text_tokens ({b}, {s}): {p:.4f} selected, {masked:.4f} [MASK], "
        f"{kept:.4f} kept, labels -100 exactly off the selection [{card}]"
    )
    return dict(resize_max_abs_err=err, resize_against_float64=err64, mlm_share=p, mlm_masked=masked, mlm_kept=kept)


def history_builds(np, users, items, n_users, n_items):
    """The padded train history (``build_train_data``'s rows, sorted and
    padded with ``n_items``) built by the native library and by the numpy
    route, on these train rows and on 1.28 M uniform rows at the elec
    geometry (192,124 × 63,001): equal, each timed on the host, the best of
    three."""
    from genmmrec_tpu_torch import native
    from genmmrec_tpu_torch.data.arrays import _pad_group_matrix

    def numpy_route(u, i, n_rows, pad):
        m, lens = _pad_group_matrix(u, i, n_rows, pad)
        return np.sort(m, axis=1), lens

    rng = np.random.default_rng(SEED + 20)
    sets = {
        "baby": (users, items, n_users, n_items),
        "elec_uniform": (rng.integers(0, 192_124, 1_280_000).astype(np.int32),
                         rng.integers(0, 63_001, 1_280_000).astype(np.int32), 192_124, 63_001),
    }
    out = {}
    for name, (u, i, n_rows, pad) in sets.items():
        got, times = {}, {}
        for route, fn in (("native", native.padded_history), ("numpy", numpy_route)):
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                got[route] = fn(u, i, n_rows, pad)
                best = min(best, time.perf_counter() - t0)
            times[route] = best
        if not all(np.array_equal(a, b) for a, b in zip(got["native"], got["numpy"])):
            raise AssertionError(f"history build, {name}: the native rows differ from numpy's")
        out[name] = dict(rows=len(u), native_s=times["native"], numpy_s=times["numpy"])
    print(f"prep_path train history, native against numpy (host s, best of 3; equal): {json.dumps(out)}")
    return out


def prep_path(torch, card):
    """The host tools on the card (``--prep-only`` runs it alone after the
    build): raw ratings and meta written from a seed at the Amazon-baby
    geometry (``prep_raw_files``), the port's preprocessing CLI
    ``rating2inter`` (5-core) → ``split`` → ``reindex-feat`` →
    ``encode-feat`` → ``uu-graph`` on the card, each step's host seconds;
    the 5-core against the core and a plain k-core; the user graph against
    the CPU, scipy and K3's plain version (``check_prep_user_graph``); the
    ``.inter`` read back by the native parser and by ``_read_inter_csv``
    (equal, times in step with the rows, both timed); the train history
    built natively and by numpy (``history_builds``); DualGNN/baby through
    ``quick_start_runs`` from these files alone (no synthetic fallback),
    its user graph read from the file (``check_prep_model_graph``);
    ``data_utils`` on the card (``check_data_utils``). Returns (summary,
    kernel cases by kernel, launches)."""
    import tempfile

    import numpy as np

    from genmmrec_tpu_torch.config import Config
    from genmmrec_tpu_torch.data.dataset import RecDataset
    from genmmrec_tpu_torch.preprocessing import pipeline
    from genmmrec_tpu_torch.preprocessing.__main__ import main as prep_main

    phase_t0 = time.perf_counter()
    cases = dict(k1=[], k1_bwd=[], k3=[])
    out = {}
    with tempfile.TemporaryDirectory() as root:
        ratings, meta, core, out["raw"] = prep_raw_files(np, root, SEED + 18)
        print(f"prep_path raw files: {json.dumps(out['raw'])}")
        d = os.path.join(root, "baby")
        steps = [
            ("rating2inter", ["rating2inter", "--ratings", ratings, "--out", d, "--dataset", "baby"]),
            ("split", ["split", "--inter", f"{d}/baby-indexed.inter", "--out", f"{d}/baby.inter"]),
            ("reindex-feat", ["reindex-feat", "--meta", meta, "--mapping", f"{d}/i_id_mapping.csv", "--out", f"{d}/meta-baby.csv"]),
            ("encode-feat", ["encode-feat", "--meta", f"{d}/meta-baby.csv", "--out", f"{d}/text_feat.npy"]),
            ("uu-graph", ["uu-graph", "--inter", f"{d}/baby.inter", "--out", f"{d}/user_graph_dict.npy"]),
        ]
        step_s = {}
        for name, argv in steps:
            if name == "uu-graph":
                reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prep_main(argv)
            torch.cuda.synchronize()
            step_s[name] = time.perf_counter() - t0
        uu_launches = launch_counts()
        out["step_s"] = step_s
        print(f"prep_path CLI steps (host seconds): {json.dumps(step_s)}; uu-graph launches {json.dumps(uu_launches)} [{card}]")
        if uu_launches["grouped_topk"] <= 0:
            raise AssertionError("uu-graph did not launch K3")

        # the 5-core: exactly the core, and a plain k-core's rows
        kcore = check_prep_kcore(d, "baby", ratings, core, out["raw"])
        n_u, n_i, plain_s = kcore["users"], kcore["items"], kcore["plain_kcore_s"]
        print(f"prep_path 5-core: {n_u} users, {n_i} items, {kcore['rows']} rows: the core's rows, equal to a plain "
              f"k-core's ({plain_s:.2f} s in dicts)")

        # the user graph
        split = pipeline.read_table(f"{d}/baby.inter", "\t")
        train = split["x_label"] == 0
        graph = np.load(f"{d}/user_graph_dict.npy", allow_pickle=True).item()
        t0 = time.perf_counter()
        out["user_graph"], k3 = check_prep_user_graph(
            torch, np, graph, split["userID"][train], split["itemID"][train], n_u, n_i, card
        )
        check_s = dict(plain_kcore=plain_s, user_graph=time.perf_counter() - t0)
        cases["k3"] += k3

        # the .inter read back by both readers, and the train history built both ways
        np.save(f"{d}/image_feat.npy", np.abs(np.random.default_rng(SEED + 19).normal(0.0, 0.3, (n_i, 4096))).astype(np.float32))
        over = {"data_path": root, "synthetic_fallback": False}
        config = Config("DualGNN", "baby", dict(over))
        nat, out["load_s"] = check_prep_readers(np, f"{d}/baby.inter")
        print(f"prep_path .inter read back: {out['load_s']['rows']} rows, native {out['load_s']['native_s']:.3f} s, "
              f"csv {out['load_s']['csv_s']:.3f} s (host), tables, labels and times equal, times in step with the rows")
        out["history_s"] = history_builds(np, nat[0][nat[2] == 0], nat[1][nat[2] == 0], n_u, n_i)
        train_ds = RecDataset(config).split()[0]

        # DualGNN/baby from these files
        def after(key, r, o):
            t0 = time.perf_counter()
            o["user_graph_file"] = check_prep_model_graph(torch, np, r["model"], train_ds, card)
            check_s["model_graph"] = time.perf_counter() - t0

        runs = (("DualGNN_prep", "DualGNN", over, dict(max_epochs=1), MP_NEED),)
        fit, fit_launches = quick_start_runs(torch, runs, card, "prep_path", after)
        out["dualgnn"] = fit["DualGNN_prep"]
        t0 = time.perf_counter()
        out["data_utils"] = check_data_utils(torch, card)
        check_s["data_utils"] = time.perf_counter() - t0
        out["check_s"] = check_s
    launches = {k: uu_launches[k] + fit_launches["DualGNN_prep"][k] for k in uu_launches}
    out["launches"] = dict(uu_graph=uu_launches, dualgnn=fit_launches["DualGNN_prep"])
    out["phase_s"] = time.perf_counter() - phase_t0
    print(f"prep_path phase done in {out['phase_s']:.1f} s (checks {json.dumps(check_s)} s); launches {json.dumps(launches)}")
    return out, cases, launches


# the zoo sweep's smoke: one epoch at baby of a model of each kind of
# path (K1 alone; K1 and K3 on an item graph; the multi-phase trainer),
# three children at once, beside them the main path's model one epoch at
# sports and at microlens, and the kernels each must launch. The sports
# child and the kernels at its shapes add 20–35 s to the phase (PERF.md
# §5): the budget takes 40 s more; the microlens child and the kernels at
# its shapes add about 20 s: 30 s more
ZOO_MODELS = ("LightGCN", "FREEDOM", "DiffMM")
ZOO_SPORTS_MODELS = ("DiffMM",)
ZOO_MICROLENS_MODELS = ("DiffMM",)
ZOO_NEED = ("grouped_topk",) + K1_BOTH
ZOO_BUDGET_S = 90.0 + 40.0 + 30.0
# DualGNN's top-k of a user's co-occurrence counts (``models/dualgnn.py``)
DUALGNN_USER_K = 40


def structured_reference(np, n_users=4000, n_items=2000, k=24, mean_degree=25.0, pop_scale=0.25, tau=0.35,
                         noise=1.0, v_dim=4096, t_dim=384):
    """The structured generator's three files as bytes, derived again from
    its seeds with numpy: the same draws in the same order, the split's
    labels set by a rank table, the rows and the ``.npy`` files formatted
    in memory."""
    import io

    rng = np.random.default_rng(0x57A7)
    U = rng.normal(0.0, 1.0 / np.sqrt(k), (n_users, k))
    V = rng.normal(0.0, 1.0 / np.sqrt(k), (n_items, k))
    pop = pop_scale * rng.normal(0.0, 1.0, n_items)
    scores = U @ V.T + pop[None, :] + tau * rng.gumbel(0.0, 1.0, (n_users, n_items))
    degree = np.clip(rng.poisson(mean_degree, n_users), 5, 120)
    order = np.argsort(-scores, axis=1)
    split = np.random.default_rng(0x5717)
    users = np.repeat(np.arange(n_users), degree)
    items = np.concatenate([order[u, : degree[u]] for u in range(n_users)])
    labels = []
    for m in degree.tolist():
        rank = np.empty(m, np.int64)
        rank[split.permutation(m)] = np.arange(m)
        cut = max(1, m // 10)
        labels.append(np.where(rank < cut, 2, np.where(rank < 2 * cut, 1, 0)))
    labels = np.concatenate(labels)
    ratings = rng.choice([3.0, 4.0, 5.0], size=len(users), p=[0.15, 0.35, 0.5])
    text = "userID\titemID\trating\ttimestamp\tx_label\n" + "".join(
        f"{u}\t{i}\t{r:.1f}\t{t}\t{x}\n" for t, (u, i, r, x) in
        enumerate(zip(users.tolist(), items.tolist(), ratings.tolist(), labels.tolist()))
    )
    frng = np.random.default_rng(0xF3A7)
    Wv, Wt = frng.normal(0.0, 1.0, (k, v_dim)), frng.normal(0.0, 1.0, (k, t_dim))
    v_sig, t_sig = V @ Wv, V @ Wt
    v = np.maximum(0.0, v_sig + noise * v_sig.std() * frng.normal(size=v_sig.shape)).astype(np.float32)
    t = (t_sig + noise * t_sig.std() * frng.normal(size=t_sig.shape)).astype(np.float32)
    files = {"baby.inter": text.encode()}
    for name, a in (("image_feat.npy", v), ("text_feat.npy", t)):
        buf = io.BytesIO()
        np.save(buf, a)
        files[name] = buf.getvalue()
    return files


def repo_script(name):
    """The module of ``scripts/<name>.py`` of this checkout."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def zoo_path(torch, card):
    """The zoo sweep on the card (``--zoo-only`` runs it alone after the
    build, budget ``ZOO_BUDGET_S``): ``scripts/zoo_sweep_torch.py`` trains
    ``ZOO_MODELS`` one epoch each at baby through ``python -m
    genmmrec_tpu_torch``, three children at once, and beside them, by a
    second and a third call, ``ZOO_SPORTS_MODELS`` one epoch at sports and
    ``ZOO_MICROLENS_MODELS`` one epoch at microlens, into journals of a
    temporary directory; each row OK (finite losses and Recall@20, a BEST
    block), each child's kernels launched, DiffMM's ``remat_gcn`` on at
    microlens alone. Then K1 and K3 at sports' and microlens' shapes
    against their plain versions (``zoo_sports_kernels``,
    ``zoo_microlens_kernels``). Then
    ``scripts/make_structured_dataset_torch.py`` at its default size (4,000
    × 2,000) with its user graph on the card: its files byte-equal to
    ``structured_reference``, its user graph against scipy's counts and K3
    against its plain version (``check_prep_user_graph``). Then
    ``scripts/zoo_report_torch.py`` on the journals: the baby rows and the
    sports and microlens rows OK in the reports. Returns (summary, kernel
    cases by kernel, launches)."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    sweep, gen, report = (repo_script(n) for n in ("zoo_sweep_torch", "make_structured_dataset_torch",
                                                   "zoo_report_torch"))
    phase_t0 = time.perf_counter()
    cases = dict(k1=[], k1_bwd=[], k3=[])
    out = {}
    launches = {}
    with tempfile.TemporaryDirectory() as root:

        def swept(dataset, models):
            """One ``sweep.main`` call, one epoch of ``models`` at ``dataset``
            at once, into a journal of ``root``; its rows checked."""
            journal = os.path.join(root, f"zoo_sweep_torch_{dataset}.json")
            t0 = time.perf_counter()
            rc = sweep.main(["-d", dataset, "--epochs", "1", "--models", *models, "--timeout", "300",
                             "--jobs", str(len(models)), "--out", journal, "--workdir", root])
            seconds = time.perf_counter() - t0
            with open(journal) as f:
                rows = json.load(f)
            for m in models:
                r = rows.get(m, {})
                child = r.get("child") or {}
                if not r.get("ok") or not math.isfinite(r.get("valid_recall@20") or float("nan")):
                    raise AssertionError(
                        f"zoo sweep: {m}/{dataset} failed (rc {r.get('returncode')}):\n{r.get('tail', '')[-3000:]}"
                    )
                key = m if dataset == "baby" else f"{m}/{dataset}"
                launches[key] = child.get("launches", {})
                never = [k for k in ZOO_NEED if launches[key].get(k, 0) <= 0]
                if never:
                    raise AssertionError(f"zoo sweep: {key} did not launch {never}: {launches[key]}")
                out[key] = {k: r.get(k) for k in ("seconds", "valid_recall@20", "test_recall@20", "epochs_run", "train_s")}
                out[key].update(setup_s=child.get("setup_s"), import_s=child.get("import_s"),
                                fit_s=child.get("fit_s"), peak_allocated_bytes=child.get("peak_allocated_bytes"),
                                remat=child.get("remat"))
            if rc != 0:
                raise AssertionError(f"zoo sweep at {dataset} returned {rc}")
            return seconds

        # the microlens child starts first, then the sports one, and both
        # run beside the three baby ones
        with ThreadPoolExecutor(max_workers=2) as pool:
            microlens = pool.submit(swept, "microlens", ZOO_MICROLENS_MODELS)
            sports = pool.submit(swept, "sports", ZOO_SPORTS_MODELS)
            out["sweep_s"] = swept("baby", ZOO_MODELS)
            out["sports_sweep_s"] = sports.result()
            out["microlens_sweep_s"] = microlens.result()
        keys = [*ZOO_MODELS, *(f"{m}/sports" for m in ZOO_SPORTS_MODELS),
                *(f"{m}/microlens" for m in ZOO_MICROLENS_MODELS)]
        print(f"zoo_path sweep: {len(ZOO_MODELS)} baby models at once in {out['sweep_s']:.1f} s, beside them "
              f"{len(ZOO_SPORTS_MODELS)} at sports in {out['sports_sweep_s']:.1f} s and {len(ZOO_MICROLENS_MODELS)} "
              f"at microlens in {out['microlens_sweep_s']:.1f} s: {json.dumps({k: out[k] for k in keys})} [{card}]")
        remat = {k: out[k]["remat"] for k in keys if k.startswith("DiffMM/")}
        if any(on != (k == "DiffMM/microlens") for k, on in remat.items()):
            raise AssertionError(f"DiffMM's remat_gcn must be on at microlens alone (115,357 nodes): {remat}")

        # K1 and K3 at the sports and microlens tiers' shapes, the card quiet
        for tier, check in (("sports", zoo_sports_kernels), ("microlens", zoo_microlens_kernels)):
            t0 = time.perf_counter()
            out[f"{tier}_kernels"], tier_cases = check(torch, torch.device("cuda:0"), card)
            out[f"{tier}_kernels_s"] = time.perf_counter() - t0
            for k, v in tier_cases.items():
                cases[k] += v

        # the structured generator at its default size, its user graph on the card
        d = os.path.join(root, "data_struct", "baby")
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen.main(["--out", d])
        torch.cuda.synchronize()
        out["generator_s"] = time.perf_counter() - t0
        gen_launches = launch_counts()
        if gen_launches["grouped_topk"] <= 0:
            raise AssertionError("the structured generator's user graph did not launch K3")
        t0 = time.perf_counter()
        ref = structured_reference(np)
        out["reference_s"] = time.perf_counter() - t0
        for name, want in ref.items():
            with open(os.path.join(d, name), "rb") as f:
                if f.read() != want:
                    raise AssertionError(f"the structured generator's {name} differs from its numpy re-derivation")
        from genmmrec_tpu_torch.preprocessing import pipeline

        t = pipeline.read_table(os.path.join(d, "baby.inter"), "\t")
        train = t["x_label"] == 0
        graph = np.load(os.path.join(d, "user_graph_dict.npy"), allow_pickle=True).item()
        n_u, n_i = len(np.unique(t["userID"])), int(t["itemID"].max()) + 1
        out["user_graph"], k3 = check_prep_user_graph(
            torch, np, graph, t["userID"][train], t["itemID"][train], n_u, n_i, card, case="struct_cooccurrence_top200"
        )
        cases["k3"] += k3
        print(f"zoo_path structured generator: {len(t['userID'])} rows, {n_u} x {n_i}, in {out['generator_s']:.1f} s "
              f"(re-derived in {out['reference_s']:.1f} s): baby.inter, image_feat.npy, text_feat.npy byte-equal; "
              f"launches {json.dumps(gen_launches)} [{card}]")

        # the report on the journal
        doc = os.path.join(root, "ZOO_RESULTS_TORCH.md")
        report.main(["baby", "--logs", root, "--out", doc])
        text = open(doc).read()
        missing = [m for m in ZOO_MODELS if not re.search(rf"^\| {m} \| OK \|", text, re.M)]
        if missing or card.split(",")[0] not in text:
            raise AssertionError(f"zoo report: rows of {missing} not OK, or the card absent")
        for tier, tier_models in (("sports", ZOO_SPORTS_MODELS), ("microlens", ZOO_MICROLENS_MODELS)):
            doc = os.path.join(root, f"ZOO_RESULTS_TORCH_{tier.upper()}.md")
            report.main([tier, "--logs", root, "--out", doc])
            text = open(doc).read()
            missing = [m for m in tier_models if not re.search(rf"^\| {m} \| OK \|", text, re.M)]
            if missing:
                raise AssertionError(f"zoo report at {tier}: rows of {missing} not OK")
    total = {k: sum(l.get(k, 0) for l in launches.values()) + gen_launches[k] for k in gen_launches}
    out["launches"] = dict(**launches, structured_generator=gen_launches)
    out["phase_s"] = time.perf_counter() - phase_t0
    print(f"zoo_path phase done in {out['phase_s']:.1f} s (budget {ZOO_BUDGET_S:.0f} s); launches {json.dumps(total)}")
    return out, cases, total


# the experiment tools' phase: the landscape's grid through K1 against the
# same grid through the plain versions, each point within this share of the
# grid's largest loss (the same float32 sums in another order), and the
# harness child's kernels
LANDSCAPE_STEPS, LANDSCAPE_DISTANCE = 11, 2.0
LANDSCAPE_RTOL = 1e-5
TOOLS_NEED = ("grouped_topk",) + K1_BOTH


def tools_path(torch, card):
    """The experiment tools on the card (``--tools-only`` runs it alone
    after the build): one epoch of LightGCN at baby through ``python -m
    genmmrec_tpu_torch`` (its grid pinned to one combination) writes the
    checkpoint, and beside it ``scripts/run_rf_models_torch.py -d baby
    --models RFBM3 --use_rf false --epochs 1`` runs one harness child (the
    YAML's grid of three), both in a temporary directory; the child's row
    OK with a finite BEST block and K1 and K3 launched. Then the
    checkpoint's loss landscape (``LANDSCAPE_STEPS``² points) through K1,
    no backward launched, and again through the plain versions: each point
    within ``LANDSCAPE_RTOL`` of the grid's largest loss, and the
    parameters equal to the checkpoint's bit for bit afterwards; K1 on the
    model's adjacency and K3 on a chunk of its scores against their plain
    versions. Returns (summary, kernel cases by kernel, launches)."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    scripts_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts")
    land, harness = repo_script("visualize_landscape_torch"), repo_script("harness_torch")
    phase_t0 = time.perf_counter()
    out, launches = {}, {}
    with tempfile.TemporaryDirectory() as root:

        def fit_lightgcn():
            cmd = harness.child_command("LightGCN", "baby", None, "cuda", 1) + [
                "--config-json", json.dumps({"hyper_parameters": ["seed"], "save_recommended_topk": False})]
            rc, text, seconds = harness.run_child(cmd, root, 600)
            row = harness.parse_run(text)
            if rc != 0 or not os.path.exists(os.path.join(root, "saved", "LightGCN-baby.pt")):
                raise AssertionError(f"tools_path: LightGCN/baby (rc {rc}) wrote no checkpoint:\n{text[-3000:]}")
            return dict(seconds=seconds, valid_recall20=row["valid_recall@20"], launches=row["launches"])

        def harness_child():
            journal = os.path.join(root, "harness.json")
            t0 = time.perf_counter()
            run = subprocess.run(
                [sys.executable, os.path.join(scripts_dir, "run_rf_models_torch.py"), "-d", "baby", "--models",
                 "RFBM3", "--use_rf", "false", "--epochs", "1", "--workdir", os.path.join(root, "h"),
                 "--journal", journal, "--timeout", "600"],
                capture_output=True, text=True, timeout=900,
            )
            seconds = time.perf_counter() - t0
            rows = json.load(open(journal)) if os.path.exists(journal) else {}
            row = rows.get("RFBM3/baby/norf") or {}
            if run.returncode != 0 or not row.get("ok"):
                raise AssertionError(f"tools_path: the harness child failed (rc {run.returncode}):\n"
                                     f"{run.stdout[-3000:]}{row.get('tail', '')}")
            return seconds, row

        with ThreadPoolExecutor(max_workers=1) as pool:
            child = pool.submit(harness_child)
            lightgcn = fit_lightgcn()
            child_s, row = child.result()
        launches["lightgcn_child"] = lightgcn.pop("launches")
        launches["harness_child"] = row["launches"]
        for key in ("lightgcn_child", "harness_child"):
            never = [k for k in TOOLS_NEED if launches[key].get(k, 0) <= 0]
            if never:
                raise AssertionError(f"tools_path: the {key} did not launch {never}: {launches[key]}")
        combos = [dict(parameters=c["parameters"], best_epoch=c["best_epoch"], valid_scores=c["valid_scores"])
                  for c in row["combinations"]]
        out["harness_child"] = dict(
            wall_s=child_s, child_s=row["seconds"], peak_allocated_bytes=row["peak_allocated_bytes"],
            valid_recall20=row["valid_recall@20"], test_recall20=row["test_recall@20"],
            best_epoch=row["best_epoch"], rf_warmup_epochs=row["rf_warmup_epochs"], combinations=combos,
        )
        out["lightgcn_child"] = lightgcn
        print(f"tools_path harness child run_rf_models_torch.py -d baby --models RFBM3 --use_rf false --epochs 1: "
              f"OK in {child_s:.1f} s, {json.dumps(out['harness_child'])}, launches {json.dumps(row['launches'])}; "
              f"beside it LightGCN/baby one epoch through the CLI in {lightgcn['seconds']:.1f} s [{card}]")

        # the landscape of the LightGCN checkpoint, on the card
        dev = torch.device("cuda:0")
        t0 = time.perf_counter()
        model, state, td = land.load_model("LightGCN", "baby", os.path.join(root, "saved", "LightGCN-baby"), dev,
                                           {"hyper_parameters": ["seed"]})
        params = dict(model.named_parameters())
        ckpt = {k: p.detach().clone() for k, p in params.items()}
        d1 = land.filter_normalize(land.random_directions(model, 1), params)
        d2 = land.filter_normalize(land.random_directions(model, 2), params)
        batch = land.landscape_batch(td, 1024, 3)
        coords = np.linspace(-LANDSCAPE_DISTANCE / 2, LANDSCAPE_DISTANCE / 2, LANDSCAPE_STEPS, dtype=np.float32)
        torch.cuda.synchronize()
        out["landscape_setup_s"] = time.perf_counter() - t0

        def grid():
            torch.cuda.synchronize()
            start = time.perf_counter()
            g = land.loss_grid(model, state, batch, d1, d2, coords, 4)
            return g, time.perf_counter() - start

        grid()  # the first points build the kernels' plans; not timed
        reset_counts()
        kernel_grid, kernel_s = grid()
        launches["landscape"] = launch_counts()
        with land.plain_versions():
            plain_grid, plain_s = grid()
        plain_launched = {k: v for k, v in launch_counts().items() if v != launches["landscape"][k]}
        if launches["landscape"]["segment_spmm"] <= 0 or launches["landscape"]["segment_spmm_backward"]:
            raise AssertionError(f"tools_path: the landscape must launch K1 forward alone: {launches['landscape']}")
        if plain_launched:
            raise AssertionError(f"tools_path: the plain landscape launched {plain_launched}")
        diff = float(np.abs(kernel_grid - plain_grid).max())
        bound = LANDSCAPE_RTOL * float(np.abs(plain_grid).max())
        if not (np.isfinite(kernel_grid).all() and diff <= bound):
            raise AssertionError(f"tools_path: the landscape through K1 and through the plain versions differ by "
                                 f"{diff:.3e} (bound {bound:.3e})")
        moved = [k for k, p in params.items() if not torch.equal(p, ckpt[k])]
        if moved:
            raise AssertionError(f"tools_path: the landscape left {moved} off the checkpoint")
        centre = float(kernel_grid[LANDSCAPE_STEPS // 2, LANDSCAPE_STEPS // 2])
        out["landscape"] = dict(steps=LANDSCAPE_STEPS, distance=LANDSCAPE_DISTANCE, grid_s=kernel_s,
                                plain_grid_s=plain_s, loss_at_checkpoint=centre, max_abs_diff_to_plain=diff,
                                bound=bound, k1_launches=launches["landscape"]["segment_spmm"])
        print(f"tools_path landscape LightGCN/baby {LANDSCAPE_STEPS}x{LANDSCAPE_STEPS} at distance "
              f"{LANDSCAPE_DISTANCE}: loss at checkpoint {centre:.6f}, through K1 in {kernel_s:.3f} s "
              f"({launches['landscape']['segment_spmm']} launches, no backward), plain versions in {plain_s:.3f} s, "
              f"largest difference {diff:.3e} (bound {bound:.3e}); parameters equal to the checkpoint's [{card}]")

        # K1 and K3 at the path's shapes against their plain versions
        cases = dict(k1=check_spmm(torch, [("landscape_lightgcn_adjacency_d64", model.norm_adj, model.latent_dim)],
                                   card)["cases"], k1_bwd=[])
        u, i = model.full_embeddings(state)
        cases["k3"] = check_k3(torch, [("tools_lightgcn_scores_top50", u[:4096] @ i.T, 50, None)], card,
                               ties_as_sets=True)["cases"]
        del model, state, td, u, i
        torch.cuda.empty_cache()
    total = {k: sum(l.get(k, 0) for l in launches.values()) for k in launch_counts()}
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - phase_t0
    print(f"tools_path phase done in {out['phase_s']:.1f} s; launches {json.dumps(total)}")
    return out, cases, total


def tier_diffmm_kernels(torch, dev, dataset, remat, card):
    """K1 and K3 at a dataset tier's shapes against their plain versions:
    the tier's tables drawn once in bulk (``elec_data``), DiffMM as
    published on them (seeded parameters; its ``remat_gcn`` must be
    ``remat``); K1 forward and backward on its adjacency at its width (on
    K1: under ``takes_blocked``'s cut), K3 on a (eval batch, n_items) chunk
    masked by the valid split's packed train positives at k = 50. Returns
    (data, model, facts, cases by kernel)."""
    from genmmrec_tpu_torch.engine.trainer import get_trainer
    from genmmrec_tpu_torch.models import get_model

    t0 = time.perf_counter()
    data = elec_data(torch, dev, dataset=dataset)
    config, td = data.config, data.td
    config["pop_mask"], config["warm_mask"] = data.pop_warm
    model = get_model("DiffMM")(config, td)
    model.init_params(torch.Generator(device=dev).manual_seed(SEED))
    trainer = get_trainer("DiffMM")(config, model)
    trainer._mask_cache = data.masks
    eval_bs = int(config["eval_batch_size"])
    mask = trainer._dense_mask(data.vd)[:eval_bs]
    torch.cuda.synchronize()
    g, d = model.norm_adj, model.latdim
    facts = dict(n_users=td.n_users, n_items=td.n_items, n_inter=td.n_inter, adjacency_rows=g.n_rows,
                 adjacency_nnz=g.nnz, blocked=g.blocked, remat=model.remat, setup_s=time.perf_counter() - t0)
    print(f"set-up: zoo_path {dataset} kernels {json.dumps(facts)} (tables drawn in bulk) [{card}]")
    if g.blocked or model.remat != remat:
        raise AssertionError(f"DiffMM at {dataset}: the adjacency must take K1 and remat_gcn be {remat}: {facts}")
    graphs = [(f"{dataset}_adjacency_d{d}", g, d)]
    cases = dict(k1=check_spmm(torch, graphs, card)["cases"], k1_bwd=check_spmm_backward(torch, graphs, card)["cases"])
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    chunk = torch.randn(eval_bs, td.n_items, generator=gen, device=dev)
    cases["k3"] = check_k3(torch, [(f"{dataset}_eval_top50_masked", chunk, 50, mask)], card)["cases"]
    return data, model, facts, cases


def zoo_sports_kernels(torch, dev, card):
    """``tier_diffmm_kernels`` at Amazon-sports (the adjacency's 53,955
    rows; ``remat_gcn`` off, under 100,000 nodes), and K3 on DiffMM's
    regeneration plane (a train batch's users) at ``rebuild_k``. Returns
    (facts, cases by kernel)."""
    from genmmrec_tpu_torch.data.arrays import interaction_vectors

    data, model, facts, cases = tier_diffmm_kernels(torch, dev, "sports", False, card)
    users = torch.arange(int(data.config["train_batch_size"]), device=dev)
    plane = model.p_sample_users(model.denoise_image, interaction_vectors(data.td, users))
    cases["k3"] += check_k3(
        torch, [(f"sports_diffmm_regenerate_top{model.rebuild_k}", plane, model.rebuild_k, None)], card
    )["cases"]
    del model, data, plane
    torch.cuda.empty_cache()
    return facts, cases


def zoo_microlens_kernels(torch, dev, card):
    """``tier_diffmm_kernels`` at MicroLens (the adjacency's 115,357 rows;
    ``remat_gcn`` on, past 100,000 nodes); ``graph.spmm`` on the same graph
    at the text features' width, 768, past K1's 512 columns (a 512 and a
    256 slice, the width MMGCN's text tower propagates) against the
    unsliced plain product (``check_sliced_spmm``); K3 at DualGNN's k on
    the first ``USER_GRAPH_BLOCK`` users' block of co-occurrence counts over
    all 98,129 users, built as ``cooccurrence_topk`` builds it, its ties
    held as sets. Returns (facts, cases by kernel)."""
    data, model, facts, cases = tier_diffmm_kernels(torch, dev, "microlens", True, card)
    td, text_d = data.td, int(data.config["synthetic_t_feat_dim"])
    name = f"microlens_adjacency_d{text_d}_sliced"
    cases["k1"].append(check_sliced_spmm(torch, name, model.norm_adj, text_d, card))
    del model
    torch.cuda.empty_cache()
    # DualGNN's first block of counts (its user graph's, ops/graph.py
    # cooccurrence_topk)
    table = data.train_ds.table
    block = cooccurrence_block(torch, table.users, table.items, td.n_users, td.n_items, 0, dev, repeats=False)
    cases["k3"] += check_k3(
        torch, [(f"microlens_dualgnn_cooccurrence_top{DUALGNN_USER_K}", block, DUALGNN_USER_K, None)], card,
        ties_as_sets=True,
    )["cases"]
    del data, block
    torch.cuda.empty_cache()
    return facts, cases


# the elec path's models, in the order it drives them (scripts/elec_scale_torch.py's)
ELEC_MODELS = ("DiffRec", "LD4MRec", "GenRecV1", "DiffMM")
# of the 627 batches of an epoch at elec (GenRecV1's and DiffMM's phase 3,
# the BPR + InfoNCE epoch; DiffRec's and LD4MRec's epoch), elec_path runs
# this many by a smoke-side batch plan; GenRecV1's and DiffMM's phases 1 and
# 2 (the regeneration builds whole graphs) run whole.
# scripts/elec_scale_torch.py runs the whole epochs.
ELEC_BATCHES = 60
# the models whose test split elec_path leaves to scripts/elec_scale_torch.py,
# and whose valid split it evaluates on its first ELEC_VALID_USERS users
# (8 of the 47 chunks of 4,096): DiffRec scores each chunk through its
# denoiser, ~55 s a split at elec (PERF.md §5), and its test split takes
# the same route as its valid one
ELEC_VALID_ONLY = ("DiffRec",)
ELEC_VALID_USERS = 8 * 4096
# the kernels each model's drive must launch, and must not
ELEC_NEED = {
    "DiffRec": (("grouped_topk",), K1_BOTH + ("segment_spmm_blocked",)),
    "LD4MRec": (("grouped_topk",), K1_BOTH + ("segment_spmm_blocked",)),
    "GenRecV1": (
        ("grouped_topk", "segment_spmm_blocked", "segment_spmm_blocked_backward") + K1_BOTH, ("fused_group_max",)
    ),
    "DiffMM": (("grouped_topk", "segment_spmm_blocked", "segment_spmm_blocked_backward"), K1_BOTH),
}


def check_remat(torch, trainer, td, card):
    """One DiffMM BPR batch on the card with ``remat`` on (the elec default)
    and off: the loss equal (the forward is the same), every ``rec``
    gradient within GRAD_RTOL of its magnitude plus GRAD_ATOL of its
    tensor's largest (the backward's scatters add in another order), and
    each run's peak memory over what was allocated before it and its time
    (the second of two runs)."""
    model = trainer.model
    batch = seeded_batch(torch, trainer, td, SEED + 7)
    names = [n for n, p in model.named_parameters() if any(p is q for q in model.param_groups()["rec"])]
    params = dict(model.named_parameters())
    runs = {}
    for remat in (True, False):
        model.remat = remat
        for _ in range(2):
            model.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            with torch.enable_grad():
                total, _ = model.loss(trainer.state, batch)
                total.backward()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - base
        runs[remat] = dict(loss=total.item(), grads={n: params[n].grad.detach().clone() for n in names},
                           peak_gb=peak / 2**30, ms=wall * 1e3)
    model.remat = True
    model.zero_grad(set_to_none=True)
    on, off = runs[True], runs[False]
    share = {}
    for n in names:
        ref, got = off["grads"][n], on["grads"][n]
        bound = GRAD_RTOL * ref.abs() + GRAD_ATOL * ref.abs().max()
        share[n] = float(((got - ref).abs() / bound.clamp(min=1e-30)).max())
    print(
        f"DiffMM/elec one BPR batch, remat on vs off: loss {on['loss']:.7f} vs {off['loss']:.7f}; rec gradients, "
        f"largest share of the bound ({GRAD_RTOL:.0e} of each entry + {GRAD_ATOL:.0e} of its tensor's largest) "
        f"{json.dumps({k: round(v, 4) for k, v in share.items()})}; peak memory over the allocated "
        f"{on['peak_gb']:.3f} GB on vs {off['peak_gb']:.3f} GB off; batch (forward + backward) {on['ms']:.1f} ms on "
        f"vs {off['ms']:.1f} ms off [{card}]"
    )
    if on["loss"] != off["loss"] or not math.isfinite(on["loss"]):
        raise AssertionError(f"DiffMM remat: loss {on['loss']} with remat, {off['loss']} without")
    bad = [n for n, v in share.items() if not v <= 1.0]
    if bad:
        raise AssertionError(f"DiffMM remat: rec gradients with and without remat differ: {bad}")
    for n in names:
        del on["grads"][n], off["grads"][n]
    return dict(loss=on["loss"], grad_bound_share=max(share.values()), peak_gb_remat=on["peak_gb"],
                peak_gb_no_remat=off["peak_gb"], ms_remat=on["ms"], ms_no_remat=off["ms"])


def graph_facts(**graphs) -> dict:
    """Each named graph's rows, nnz, longest row and kernel (K1 or K2)."""
    return {
        name: dict(n_rows=g.n_rows, nnz=g.nnz, longest_row=int((g.row_ptr[1:] - g.row_ptr[:-1]).max()),
                   kernel="K2" if g.blocked else "K1")
        for name, g in graphs.items()
    }


def elec_path(torch, dev, card, data=None, profile_dir=None):
    """DiffRec, LD4MRec, GenRecV1 and DiffMM at the Amazon-elec tier
    (192,403 users x 63,001 items) through ``get_model`` and
    ``get_trainer``, on one data set (``synthetic_tables``, drawn in bulk)
    and the tier's seeded features (drawn once for the three multimodal
    models). For each model: the set-up timed apart (LD4MRec's ``svds``,
    GenRecV1's KNN graphs and clustering in it), one epoch of every phase
    (phase 3 of GenRecV1 and DiffMM and the epoch of DiffRec and LD4MRec
    cut to ``ELEC_BATCHES`` by a batch plan), ``evaluate`` of valid and test
    in float32 (for ``ELEC_VALID_ONLY`` valid alone, on its users below
    ``ELEC_VALID_USERS``); losses and
    metrics finite, no train positive in any top-50, the launches of each
    drive. On the card, after each drive, K1, K2 and K3 against their plain
    versions at its shapes: GenRecV1's KNN block (8,192 x 63,001, k = 10),
    regeneration planes (k = 5 and 10), both KNN graphs, R and its
    generated graph; DiffMM's top-1 plane, both modal graphs and K2's
    backward on one; DiffMM's remat on at elec, one batch with remat on
    against off, and one batch against the CPU.
    ``data`` is the ``elec_data`` to drive (built here when None; another
    tier's gives a dry run of the control flow at a small size on the CPU,
    where the kernel and launch checks are skipped). Returns (summary,
    kernel cases by kernel, launches of the four drives)."""
    from genmmrec_tpu_torch.config import Config
    from genmmrec_tpu_torch.data.arrays import build_eval_data, interaction_vectors
    from genmmrec_tpu_torch.engine.trainer import get_trainer
    from genmmrec_tpu_torch.models import base as model_base
    from genmmrec_tpu_torch.models import get_model
    from genmmrec_tpu_torch.ops.graph import KNN_BLOCK

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    out, launches = {}, {}
    cases = dict(k1=[], k1_bwd=[], k2=[], k2_bwd=[], k3=[])
    path_t0 = time.perf_counter()

    # -- (a) one data set and one feature draw for the four models ----------
    data = data or elec_data(torch, dev)
    dataset, train_ds, td, vd, ted = data.dataset, data.train_ds, data.td, data.vd, data.ted
    over = data.overrides
    out["data_s"] = data.data_s
    t0 = time.perf_counter()
    feats = model_base.load_modal_features(data.config, td.n_items)
    out["features_s"] = time.perf_counter() - t0
    print(
        f"set-up: elec_path data {dataset} users={td.n_users} items={td.n_items} train_inters={td.n_inter} "
        f"valid_users={vd.n_users_eval} test_users={ted.n_users_eval} in {out['data_s']:.1f} s (host, tables "
        f"drawn in bulk); the tier's features {tuple(feats[0].shape)} + {tuple(feats[1].shape)} in "
        f"{out['features_s']:.1f} s (host) [{card}]"
    )

    loader = model_base.load_modal_features
    model_base.load_modal_features = lambda config, n_items: feats
    try:
        for name in ELEC_MODELS:
            res = {}
            config = Config(name, dataset, over)
            config["pop_mask"], config["warm_mask"] = data.pop_warm

            def timed(label, fn):
                sync()
                t0 = time.perf_counter()
                value = fn()
                sync()
                res[f"{label}_s"] = time.perf_counter() - t0
                return value

            # -- set-up ----------------------------------------------------
            reset_counts()
            model = timed("setup_model", lambda: get_model(name)(config, td))
            model.init_params(torch.Generator(device=dev).manual_seed(SEED))
            trainer = timed("setup_trainer", lambda: get_trainer(name)(config, model))
            trainer._mask_cache = data.masks  # shared: built once for each eval set
            trainer._build_train_step(td)
            if len(data.masks) < 2:
                timed("packed_masks", lambda: (trainer._dense_mask(vd), trainer._dense_mask(ted)))
            # -- one epoch of every phase -----------------------------------
            B = trainer.train_batch_size
            prelude = hasattr(trainer, "_diffusion_epoch")
            if prelude:
                gen = trainer.split("epoch", 0, "prelude")
                losses = timed("phase1", lambda: trainer._diffusion_epoch(gen).cpu())
                res["phase1_batches"] = losses.shape[0]
                res["phase1_loss"] = trainer._loss_log(losses)
                timed("phase2", lambda: trainer.regenerate(gen))
            gen = trainer.split("epoch", 0, "train")
            perm = torch.randperm(trainer._num_batches * B, generator=gen, device=dev).reshape(-1, B)
            plan = {"idx": perm[:ELEC_BATCHES]}
            losses = timed("phase3" if prelude else "epoch", lambda: trainer._train_epoch(gen, plan=plan).cpu())
            res.update(batches=losses.shape[0], of_batches=trainer._num_batches,
                       loss_first=float(losses[0, 0]), loss_last=float(losses[-1, 0]))
            finite = bool(torch.isfinite(losses).all()) and all(
                math.isfinite(v) for v in res.get("phase1_loss", {}).values())
            if not finite:
                raise AssertionError(f"{name}/elec: a training loss is not finite: {res}")
            # -- evaluate(valid), evaluate(test) in float32 -----------------
            splits = (("test", ted, True),)
            if name in ELEC_VALID_ONLY:
                part = data.valid_ds.copy(data.valid_ds.table.subset(data.valid_ds.table.users < ELEC_VALID_USERS))
                splits = (("valid", build_eval_data(part, train_ds, int(config["eval_batch_size"]), dev), False),)
            else:
                splits = (("valid", vd, False),) + splits
            for split, ed, is_test in splits:
                top = timed(f"eval_{split}_topk", lambda: trainer.eval_topk(ed))
                got = timed(f"eval_{split}_metrics", lambda: trainer.evaluator.evaluate(
                    top, ed, pop_mask=trainer.pop_mask, warm_mask=trainer.warm_mask if is_test else None,
                    is_test=is_test,
                ))
                res[f"eval_{split}_s"] = res.pop(f"eval_{split}_topk_s") + res.pop(f"eval_{split}_metrics_s")
                bad = [k for k, v in got.items() if not math.isfinite(v)]
                if bad:
                    raise AssertionError(f"{name}/elec {split}: non-finite metrics {bad}")
                mask = trainer._dense_mask(ed)
                listed = (mask.gather(1, top >> 3) >> (top & 7).to(torch.uint8)) & 1
                if top.min().item() < 0 or listed[ed.valid].any():
                    raise AssertionError(f"{name}/elec {split}: a pad entry or a train positive is in the top-50")
                res[split] = got
            launches[name] = launch_counts()
            if on_card:
                need, stray = ELEC_NEED[name]
                missing = [k for k in need if launches[name][k] <= 0]
                extra = [k for k in stray if launches[name][k] > 0]
                if missing or extra:
                    raise AssertionError(f"{name}/elec: not launched {missing}, stray {extra}: {launches[name]}")
            phases = (
                f"phase 1 {res['phase1_s']:.2f} s ({res['phase1_batches']} batches, loss "
                f"{json.dumps({k: round(v, 4) for k, v in res['phase1_loss'].items()})}), phase 2 (regenerate) "
                f"{res['phase2_s']:.2f} s, phase 3 {res['phase3_s']:.2f} s"
                if prelude else f"epoch {res['epoch_s']:.2f} s"
            )
            print(
                f"elec_path {name}: set-up model {res['setup_model_s']:.2f} s + trainer {res['setup_trainer_s']:.2f} s"
                f"{'; packed masks %.2f s' % res['packed_masks_s'] if 'packed_masks_s' in res else ''}; {phases} "
                f"({res['batches']} of {res['of_batches']} batches of {B}, loss first {res['loss_first']:.5f} last "
                f"{res['loss_last']:.5f}); evaluate(valid) {res['eval_valid_s']:.2f} s"
                + (f" (its first {splits[0][1].n_users_eval} of {vd.n_users_eval} users)" if name in ELEC_VALID_ONLY else "")
                + (f", evaluate(test) {res['eval_test_s']:.2f} s" if "test" in res else "")
                + f"; Recall@20 valid {res['valid']['recall@20']:.4f}"
                + (f" test {res['test']['recall@20']:.4f}" if "test" in res else "")
                + f"; losses and metrics finite, no train positive in any top-50; "
                f"launches {json.dumps(launches[name])} [{card}]"
            )

            # -- the kernels at the drive's shapes, against their plain versions
            if name == "GenRecV1":
                res["graphs"] = graph_facts(
                    adjacency=model.norm_adj, R=model.R, image_knn=model.image_II, text_knn=model.text_II,
                    generated=trainer.state["image_ui"],
                )
                res["clusters"] = {m: int(trainer.debias_tables[f"{m}_labels"].max()) + 1 for m in ("img", "txt")}
                res["cluster_s"] = trainer.cluster_s
                print(f"elec_path GenRecV1 graphs {json.dumps(res['graphs'])}, clusters {json.dumps(res['clusters'])} "
                      f"in {res['cluster_s']:.2f} s of the trainer's set-up")
            if name == "DiffMM":
                if dataset == "elec" and not model.remat:
                    raise AssertionError("DiffMM at elec: remat_gcn absent, yet remat is off")
                res["remat"] = model.remat
                res["graphs"] = graph_facts(
                    adjacency=model.norm_adj, image_ui=trainer.state["image_ui"], text_ui=trainer.state["text_ui"]
                )
                print(f"elec_path DiffMM: remat {'on' if model.remat else 'off'} ({td.n_users + td.n_items} nodes, "
                      f"remat_gcn absent); graphs {json.dumps(res['graphs'])}")
            if on_card and name == "GenRecV1":
                f = torch.nn.functional.normalize(model.v_feat, dim=1, eps=1e-12)
                cases["k3"] += check_k3(
                    torch, [("elec_genrecv1_knn_block_top10", f[:KNN_BLOCK] @ f.T, model.knn_k, None)], card
                )["cases"]
                del f
                users0 = torch.arange(B, device=dev)
                blended, probs = trainer.generate_chunk(users0, torch.Generator(device=dev).manual_seed(SEED + 3))
                cases["k3"] += check_k3(
                    torch,
                    [("elec_genrecv1_gen_top5", probs, model.gen_topk, None),
                     ("elec_genrecv1_rebuild_top10", blended * probs, model.rebuild_k, None)],
                    card,
                )["cases"]
                del blended, probs
                cases["k1"] += check_spmm(
                    torch,
                    [("elec_genrecv1_image_knn_d64", model.image_II, model.latdim),
                     ("elec_genrecv1_text_knn_d64", model.text_II, model.latdim),
                     ("elec_genrecv1_R_d128", model.R, 2 * model.latdim)],
                    card,
                )["cases"]
                cases["k2"] += check_spmm(
                    torch, [("elec_genrecv1_generated_d64", trainer.state["image_ui"], model.latdim)], card,
                    blocked=True,
                )["cases"]
            if on_card and name == "DiffMM":
                users0 = torch.arange(B, device=dev)
                plane = model.p_sample_users(model.denoise_image, interaction_vectors(td, users0))
                cases["k3"] += check_k3(torch, [("elec_diffmm_regenerate_top1", plane, model.rebuild_k, None)],
                                        card)["cases"]
                del plane
                modal = [(f"elec_diffmm_{m}_d128", trainer.state[m], 2 * model.latdim) for m in ("image_ui", "text_ui")]
                cases["k2"] += check_spmm(torch, modal, card, blocked=True)["cases"]
                cases["k2_bwd"] += check_spmm_backward(torch, modal[:1], card, blocked=True)["cases"]
                res["remat_check"] = check_remat(torch, trainer, td, card)
                res["batch_vs_cpu"] = check_batch_against_cpu(
                    torch, trainer, td, train_ds, config, card, replay_branches=True
                )
                if profile_dir:
                    profile_batches(torch, trainer, perm[ELEC_BATCHES : ELEC_BATCHES + 10], profile_dir,
                                    "DiffMM_elec", card)
            if on_card and name == "GenRecV1" and profile_dir:
                profile_batches(torch, trainer, perm[ELEC_BATCHES : ELEC_BATCHES + 10], profile_dir,
                                "GenRecV1_elec", card)
            out[name] = res
            del trainer, model
            if on_card:
                torch.cuda.empty_cache()
    finally:
        model_base.load_modal_features = loader
    out["phase_s"] = time.perf_counter() - path_t0
    total = {k: sum(l[k] for l in launches.values()) for k in launch_counts()}
    print(f"elec_path phase done in {out['phase_s']:.1f} s; launches of the four drives {json.dumps(total)} [{card}]")
    return dict(**out, launches=launches), cases, total


def profile_batches(torch, trainer, idx, profile_dir, label, card):
    """``idx``'s batches of the BPR epoch under ``torch.profiler``, their
    kernel table into ``profile_dir``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer._train_epoch(trainer.split("smoke", "profile"), plan={"idx": idx})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    write_profile(torch, prof, profile_dir, f"{label}_{idx.shape[0]}_batches", wall, card)


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
        "training batches and two more evaluations of LightGCN, ten more batches of each message-passing "
        "model, into DIR",
    )
    parser.add_argument(
        "--mp-only", action="store_true",
        help="only build the kernels and run the message-passing phase (mp_path), and stop",
    )
    parser.add_argument(
        "--prep-only", action="store_true",
        help="only build the kernels and run the host tools' phase (prep_path), and stop",
    )
    parser.add_argument(
        "--mmg-only", action="store_true",
        help="only build the kernels and run the last multimodal graph models' phase (mmg_path), and stop",
    )
    parser.add_argument(
        "--diff-only", action="store_true",
        help="only build the kernels and run the diffusion recommenders' phase (diff_path), and stop",
    )
    parser.add_argument(
        "--rf-only", action="store_true",
        help="only build the kernels and run the Rectified-Flow family's phase (rf_path), and stop",
    )
    parser.add_argument(
        "--mesh-only", action="store_true",
        help="only build the kernels and run the multi-device layer's phase (mesh_path), and stop",
    )
    parser.add_argument(
        "--elec-only", action="store_true",
        help="only build the kernels and run the elec-scale diffusion models' phase (elec_path), and stop",
    )
    parser.add_argument(
        "--zoo-only", action="store_true",
        help="only build the kernels and run the zoo sweep's phase (zoo_path), and stop",
    )
    parser.add_argument(
        "--tools-only", action="store_true",
        help="only build the kernels and run the experiment tools' phase (tools_path), and stop",
    )
    parser.add_argument(
        "--k5a-against", nargs="+", metavar="DIR",
        help="only time this checkout's K5a against the K5a of each other checkout DIR, in turns, and stop",
    )
    args = parser.parse_args()
    if args.profile:
        # the model phases run in a temporary working directory
        args.profile = os.path.abspath(args.profile)
    smoke_t0 = time.perf_counter()

    from genmmrec_tpu_torch import native
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
    t0 = time.perf_counter()
    native.get_lib()
    print(f"built and loaded {native.library_path()} in {time.perf_counter() - t0:.1f} s (g++)")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")
    if args.k5a_against:
        print(json.dumps({"k5a_against": k5a_against(torch, args.k5a_against, card)}))
        return 0
    generate_once()
    if args.mp_only:
        mp, mp_cases, mp_launches = mp_path(torch, card, args.profile)
        print(json.dumps({"mp_path": dict(**mp, launches_total=mp_launches), "kernel_cases": mp_cases}))
        return 0
    if args.prep_only:
        prep, prep_cases, prep_launches = prep_path(torch, card)
        print(json.dumps({"prep_path": dict(**prep, launches_total=prep_launches), "kernel_cases": prep_cases}))
        return 0
    if args.mmg_only:
        mmg, mmg_cases, mmg_launches = mmg_path(torch, card, args.profile)
        print(json.dumps({"mmg_path": dict(**mmg, launches_total=mmg_launches), "kernel_cases": mmg_cases}))
        return 0
    if args.diff_only:
        diff, diff_cases, diff_launches = diff_path(torch, card, args.profile)
        print(json.dumps({"diff_path": dict(**diff, launches_total=diff_launches), "kernel_cases": diff_cases}))
        return 0
    if args.rf_only:
        rfp, rf_cases, rf_launches = rf_path(torch, card, args.profile)
        print(json.dumps({"rf_path": dict(**rfp, launches_total=rf_launches), "kernel_cases": rf_cases}))
        return 0
    if args.mesh_only:
        mesh, mesh_cases, mesh_launches = mesh_path(torch, card)
        print(json.dumps({"mesh_path": dict(**mesh, launches_total=mesh_launches), "kernel_cases": mesh_cases}))
        return 0
    if args.zoo_only:
        zoo, zoo_cases, zoo_launches = zoo_path(torch, card)
        print(json.dumps({"zoo_path": dict(**zoo, launches_total=zoo_launches), "kernel_cases": zoo_cases}))
        print(f"chip_smoke: the build and zoo_path done in {time.perf_counter() - smoke_t0:.1f} s [{card}]")
        return 0
    if args.tools_only:
        tools, tools_cases, tools_launches = tools_path(torch, card)
        print(json.dumps({"tools_path": dict(**tools, launches_total=tools_launches), "kernel_cases": tools_cases}))
        print(f"chip_smoke: the build and tools_path done in {time.perf_counter() - smoke_t0:.1f} s [{card}]")
        return 0
    if args.elec_only:
        elec_d, elec_cases, elec_d_launches = elec_path(torch, torch.device("cuda:0"), card, profile_dir=args.profile)
        print(json.dumps({"elec_path": dict(**elec_d, launches_total=elec_d_launches), "kernel_cases": elec_cases}))
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
    elec_set = elec_data(torch, dev)  # LightGCN's and elec_path's
    elec = graph_cf_setup(torch, dev, data=elec_set)
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
    del elec, adj
    torch.cuda.empty_cache()

    # -- phase 7b: DiffRec, LD4MRec, GenRecV1 and DiffMM at the elec tier ---
    elec_d, elec_cases, elec_d_launches = elec_path(torch, dev, card, data=elec_set, profile_dir=args.profile)
    del elec_set
    k1["cases"] += elec_cases["k1"]
    k2["cases"] += elec_cases["k2"]
    k2_bwd["cases"] += elec_cases["k2_bwd"]
    k3["cases"] += elec_cases["k3"]
    torch.cuda.empty_cache()

    # -- phase 8: the CLI, quick_start and python -m genmmrec_tpu_torch ----
    cli, cli_cases, cli_launches = cli_path(torch, card)
    # -- phase 9: the message-passing models -------------------------------
    mp, mp_cases, mp_launches = mp_path(torch, card, args.profile)
    # -- phase 9b: the host tools, raw ratings to DualGNN/baby -------------
    prep, prep_cases, prep_launches = prep_path(torch, card)
    # -- phase 10: the last multimodal graph models ------------------------
    mmg, mmg_cases, mmg_launches = mmg_path(torch, card, args.profile)
    # -- phase 11: the diffusion recommenders ------------------------------
    diff, diff_cases, diff_launches = diff_path(torch, card, args.profile)
    # -- phase 12: the Rectified-Flow family -------------------------------
    rfp, rf_cases, rf_launches = rf_path(torch, card, args.profile)
    # -- phase 13: the multi-device layer ------------------------------------
    mesh, mesh_cases, mesh_launches = mesh_path(torch, card)
    # -- phase 14: the zoo sweep, its structured data and its report -------
    zoo, zoo_cases, zoo_launches = zoo_path(torch, card)
    # -- phase 15: the experiment tools, the landscape and a harness child --
    tools, tools_cases, tools_launches = tools_path(torch, card)
    for cs in (cli_cases, mp_cases, prep_cases, mmg_cases, diff_cases, rf_cases, mesh_cases, zoo_cases,
               tools_cases):
        k1["cases"] += cs["k1"]
        k1_bwd["cases"] += cs["k1_bwd"]
        k3["cases"] += cs["k3"]

    launches = {
        k: serving_launches[k] + switched_launches[k] + bf16_launches[k] + training_launches[k] + wide_launches[k]
        + elec_launches[k] + elec_d_launches[k] + genrec_launches[k] + cli_launches[k] + mp_launches[k] + prep_launches[k] + mmg_launches[k]
        + diff_launches[k] + rf_launches[k] + mesh_launches[k] + zoo_launches[k] + tools_launches[k]
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
        elec_path=dict(**elec_d, launches_total=elec_d_launches),
        genrecv1_baby=dict(**genrec, launches_total=genrec_launches),
        cli=dict(**cli, launches_total=cli_launches), mp_path=dict(**mp, launches_total=mp_launches),
        prep_path=dict(**prep, launches_total=prep_launches),
        mmg_path=dict(**mmg, launches_total=mmg_launches), diff_path=dict(**diff, launches_total=diff_launches),
        rf_path=dict(**rfp, launches_total=rf_launches),
        mesh_path=dict(**mesh, launches_total=mesh_launches),
        zoo_path=dict(**zoo, launches_total=zoo_launches),
        tools_path=dict(**tools, launches_total=tools_launches),
        card=card,
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
