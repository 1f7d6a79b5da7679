"""K3 and K4: exact masked top-k over the rows of a score matrix.

Counterpart of ``genmmrec_tpu/ops/topk.py`` ``grouped_topk``, whose Pallas
kernels are ``_gather_kernel``, the candidate gather of the two-stage
selection (K3), and ``_extract_kernel``, the opt-in candidate extraction
(K4). On the card K3, ``genmmrec_tpu_torch/csrc/topk.cu``, serves every
width and every ``1 <= k <= n``, as the reference does, over float32 or
bfloat16 rows (the bf16 evaluation's score and candidate planes). For
``k <= NARROW_K`` one block a row reads the row in 16-byte vectors, takes
the k-th largest of its 256 threads' maxima as the row's threshold,
collects the columns at or above it in shared memory and ranks them by one
64-bit compare (an order-preserving key above the complemented index); a
row that passes more columns than the buffer holds (constant, mostly
``-inf``, tied at the threshold) is finished exactly by a radix select in
the same kernel; ``k = 1`` has a one-pass kernel of its own. A wider k goes
straight to the radix select; its k columns are ranked in the buffer up to
``_K3_CAP`` and written in no order past it, and ``_masked_topk`` orders
them by a stable sort of the (b, k) result. ``grouped_topk_selection_plain``
mirrors that selection step by step in PyTorch, for the tests. K4,
``genmmrec_tpu_torch/csrc/topk_extract.cu``, is the second stage of the
two-stage selection: the top-k of the 128-wide groups that the group maxima
picked, up to ``MAX_EXTRACT_GROUPS`` of them. It ranks like K3 without
rounds: the k-th largest of the chosen groups' maxima is the threshold, the
keys at or above it are ranked once, an overflowing row goes through the
radix select; ``candidate_extract_selection_plain`` mirrors it. The same
source folds a row's scores and mask bits into its group maxima
(``masked_group_max``). Their sources say what bounds them and how they are
laid out.

Contract: values in descending order, ties broken by the lower index first
(``lax.top_k``'s rule). ``packed_mask`` is an optional (b, >= ceil(n/8))
uint8 bit matrix, little-endian (numpy ``packbits(axis=1,
bitorder="little")``), marking columns to exclude; excluded columns take
part with the value ``-inf``, and are listed in index order when a row runs
out of finite values. ``-0`` ranks as ``+0``; a NaN ranks above ``+inf``,
as in ``torch.sort`` and ``lax.top_k``. Values keep the scores' type;
indices are int64.

``grouped_topk`` takes K3. With ``GENMMREC_PALLAS_TOPK`` set in the
environment (the reference's own switch, read at each call) and more than
``2k`` groups in a row (the reference's narrow-row rule), it takes the
two-stage route instead: the masked group maxima (a kernel of K4's source;
XLA ops outside the kernel in the reference), the choice of
``min(k, n_groups)`` groups by K3 on the maxima, then K4,
``candidate_extract``. A k above
``MAX_EXTRACT_GROUPS`` needs more groups than K4 holds, and such a call
takes K3 on the whole row (``takes_two_stage``). The groups are ranked by
(maximum descending, id ascending) and handed on sorted by id, so that a
lower position among the candidates is a lower item index and both routes
give the same lists bit for bit.

Each wrapper takes its plain PyTorch version for tensors on the CPU and
launches its kernel for CUDA tensors, or raises.
"""

from __future__ import annotations

import os

import torch

from genmmrec_tpu_torch.ops import _build

# the widest k of K3's threshold path; a wider k takes its radix path
NARROW_K = 64
# the most groups a row that K4 takes
MAX_EXTRACT_GROUPS = 448
GROUP = 128
# the kernels' C entry points for each score type they take
_ENTRY = {torch.float32: "masked_topk_f32", torch.bfloat16: "masked_topk_bf16"}
_EXTRACT_ENTRY = {torch.float32: "candidate_extract_f32", torch.bfloat16: "candidate_extract_bf16"}
_FOLD_ENTRY = {torch.float32: "masked_group_max_f32", torch.bfloat16: "masked_group_max_bf16"}


def unpack_mask(packed_mask: torch.Tensor, n: int) -> torch.Tensor:
    """(b, n_bytes) little-endian bits → (b, n) bool."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed_mask.device)
    bits = (packed_mask[:, :, None] >> shifts) & 1
    return bits.reshape(packed_mask.shape[0], -1)[:, :n].bool()


def grouped_topk_plain(scores, k: int, packed_mask=None):
    """Mask with ``-inf``, then a full stable descending sort."""
    if not 1 <= k <= scores.shape[1]:
        raise ValueError(f"k={k} must be in [1, {scores.shape[1]}]")
    if packed_mask is not None:
        scores = scores.masked_fill(unpack_mask(packed_mask, scores.shape[1]), float("-inf"))
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


# K3's selection, mirrored for the tests: the constants of csrc/topk.cu
_K3_THREADS = 256
_K3_CAP = 512


def order_key(scores: torch.Tensor) -> torch.Tensor:
    """K3's and K4's order-preserving key of float32 or bfloat16 scores, as
    int64 in [1, 2**32): a larger score has a larger key, ``-0`` and ``+0``
    share one, every NaN has the largest. A bfloat16's key is that of the
    float32 it widens to, without the lower 16 bits."""
    if scores.dtype == torch.bfloat16:
        bits = (scores.contiguous().view(torch.int16).to(torch.int64) & 0xFFFF) << 16
    else:
        bits = scores.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = torch.where(bits == 0x80000000, 0, bits)
    key = torch.where(bits >= 0x80000000, ~bits & 0xFFFFFFFF, bits | 0x80000000)
    key = torch.where((bits & 0x7FFFFFFF) > 0x7F800000, 0xFFFFFFFF, key)
    return key & 0xFFFF0000 if scores.dtype == torch.bfloat16 else key


def _radix_topk(key, k: int, key_bytes: int):
    """The radix select of K3 and K4 over (b, m) int64 keys: the k-th largest
    key of each row, a byte at a time from the top (a 256-bin histogram of
    the keys that match the bytes found so far), then the top-k as a mask:
    the keys above it and the first of those equal to it. Returns (mask,
    k-th key (b, 1))."""
    b, dev = key.shape[0], key.device
    prefix = torch.zeros(b, 1, dtype=torch.int64, device=dev)
    known = 0
    want = torch.full((b, 1), k, dtype=torch.int64, device=dev)
    for shift in (24, 16, 8, 0)[:key_bytes]:
        live = (key & known) == prefix
        hist = torch.zeros(b, 256, dtype=torch.int64, device=dev).scatter_add_(1, (key >> shift) & 255, live.long())
        above = hist.flip(1).cumsum(1).flip(1) - hist  # keys in the bins above each bin
        chosen = ((above < want) & (want <= above + hist)).long().argmax(dim=1, keepdim=True)
        want = want - above.gather(1, chosen)
        prefix = prefix | (chosen << shift)
        known |= 255 << shift
    ties = key == prefix
    return (key > prefix) | (ties & (ties.cumsum(1) - 1 < want)), prefix


def grouped_topk_selection_plain(scores, k: int, packed_mask=None, head: int = 0, with_counts: bool = False):
    """K3's selection, step by step, in plain PyTorch; the tests hold it
    against ``grouped_topk_plain``. ``head`` is the number of columns before
    a row's first 16-byte vector (the kernel derives it from the row's
    address). For ``k <= NARROW_K``: thread maxima over the kernel's
    interleaved columns, their k-th largest as the threshold, the columns at
    or above it ranked by (key, lower index); a row that passes more than the
    buffer's ``_K3_CAP`` columns goes through the radix select of the key's
    bytes, then takes the columns above the k-th key and the lowest-indexed
    of those equal to it. A wider k takes the radix select for every row.
    With ``with_counts`` also returns how many columns passed each row's
    threshold (for a wider k: how many are at or above the k-th key)."""
    b, n = scores.shape
    if not 1 <= k <= n:
        raise ValueError(f"k={k} must be in [1, {n}]")
    dev = scores.device
    if packed_mask is not None:
        scores = scores.masked_fill(unpack_mask(packed_mask, n), float("-inf"))
    key = order_key(scores)
    col = torch.arange(n, device=dev)
    exact, prefix = _radix_topk(key, k, 2 if scores.dtype == torch.bfloat16 else 4)
    if k > NARROW_K:
        taken, counts = exact, (key >= prefix).sum(dim=1)
    else:
        # which thread visits a column: the vectors interleave, the
        # unaligned ends go one a thread
        v = 8 if scores.dtype == torch.bfloat16 else 4
        head = min(head, n)
        tail = head + (n - head) // v * v
        owner = torch.where(col < head, col, torch.where(col >= tail, head + col - tail, (col - head) // v % _K3_THREADS))
        tmax = torch.zeros(b, _K3_THREADS, dtype=torch.int64, device=dev)
        tmax.scatter_reduce_(1, owner.expand(b, n), key, "amax")
        t = torch.sort(tmax, dim=1, descending=True).values[:, k - 1 : k]
        passed = key >= t
        counts = passed.sum(dim=1)
        if bool((counts < k).any()):
            raise AssertionError("fewer than k columns at or above the threshold")
        taken = torch.where((counts > _K3_CAP)[:, None], exact, passed)
    # one word a candidate: the key above the complemented index
    word = torch.where(taken, (key << 31) | (0x7FFFFFFF - col), -1)
    idx = 0x7FFFFFFF - (torch.sort(word, dim=1, descending=True).values[:, :k] & 0x7FFFFFFF)
    out = scores.gather(1, idx), idx
    return (*out, counts) if with_counts else out


def order_rows(vals, idx):
    """Each row's (value, index) pairs in the top-k contract's order: by
    index, then stably by value descending (a NaN first, as K3 ranks it;
    -0 and +0 equal)."""
    idx, by_index = torch.sort(idx, dim=1)
    vals, by_value = torch.sort(vals.gather(1, by_index), dim=1, descending=True, stable=True)
    return vals, idx.gather(1, by_value)


def _mask_args(packed_mask, b: int, n: int, device):
    """(pointer, row stride) of a checked packed mask, or (None, 0)."""
    if packed_mask is None:
        return None, 0
    if (
        packed_mask.device != device
        or packed_mask.dtype != torch.uint8
        or not packed_mask.is_contiguous()
        or packed_mask.dim() != 2
        or packed_mask.shape[0] != b
        or packed_mask.shape[1] < -(-n // 8)
    ):
        raise ValueError(f"packed_mask must be a contiguous uint8 ({b}, >= {-(-n // 8)}) tensor")
    return packed_mask.data_ptr(), packed_mask.shape[1]


def _check_scores(scores, k: int, widest: int):
    if scores.dtype not in _ENTRY or scores.dim() != 2 or not scores.is_contiguous():
        raise ValueError("scores must be a contiguous 2-D float32 or bfloat16 tensor")
    if not 1 <= k <= widest:
        raise ValueError(f"k={k} must be in [1, {widest}]")


def _masked_topk(scores, k: int, packed_mask=None):
    """K3 on CUDA scores."""
    _check_scores(scores, k, scores.shape[1])
    b, n = scores.shape
    mask_ptr, mask_stride = _mask_args(packed_mask, b, n, scores.device)
    vals = torch.empty(b, k, dtype=scores.dtype, device=scores.device)
    idx = torch.empty(b, k, dtype=torch.int64, device=scores.device)
    _build.launch(
        _ENTRY[scores.dtype], "grouped_topk", scores.device,
        scores.data_ptr(), mask_ptr, mask_stride, vals.data_ptr(), idx.data_ptr(), b, n, k,
    )
    grouped_topk.launches += 1
    # past the buffer the kernel writes a row's k columns in no order
    return order_rows(vals, idx) if k > _K3_CAP else (vals, idx)


def _candidate_plane(scores, gidx, packed_mask=None):
    """The (b, kp * 128) candidates of the groups ``gidx`` in flat position
    order, masked at ``-inf``, with their items; a pad entry (a pad slot, or
    a column past the row's end) is ``-inf`` with an item >= n."""
    b, n = scores.shape
    ng, kp = -(-n // GROUP), gidx.shape[1]
    neg = float("-inf")
    if packed_mask is not None:
        scores = scores.masked_fill(unpack_mask(packed_mask, n), neg)
    # the catalog's tail and one more group, the pad slot, at -inf
    plane = torch.nn.functional.pad(scores, (0, (ng + 1) * GROUP - n), value=neg).view(b, ng + 1, GROUP)
    slot = torch.where((gidx < 0) | (gidx >= ng), ng, gidx).long()
    cand = plane.gather(1, slot[:, :, None].expand(b, kp, GROUP)).reshape(b, -1)
    item = (slot[:, :, None] * GROUP + torch.arange(GROUP, device=scores.device)).reshape(b, -1)
    return cand, item


def candidate_extract_plain(scores, gidx, k: int, packed_mask=None):
    """The candidates in flat position order with the pad entries moved
    behind every real one, then a stable descending sort."""
    n = scores.shape[1]
    cand, item = _candidate_plane(scores, gidx, packed_mask)
    real_first = torch.sort((item >= n).to(torch.uint8), dim=1, stable=True).indices
    vals, order = torch.sort(cand.gather(1, real_first), dim=1, descending=True, stable=True)
    idx = item.gather(1, real_first.gather(1, order[:, :k]))
    return vals[:, :k], torch.where(idx < n, idx, -1)


# K4's candidate buffer (csrc/topk_extract.cu), 64-bit words: twice k, at
# least 128 and at most _K4_CAP; past _K4_CAP the kernel lists a row's k
# entries in no order and the wrapper orders them
_K4_CAP = 512


def _k4_cap(k: int) -> int:
    return min(_K4_CAP, max(128, 2 * k))


def candidate_extract_selection_plain(scores, gidx, k: int, packed_mask=None, with_counts: bool = False):
    """K4's selection, step by step, in plain PyTorch; the tests hold it
    against ``candidate_extract_plain``. The candidates' order keys (0 for a
    pad entry), each chosen group's maximum key, the k-th largest of those as
    the threshold (0, where every candidate passes, if kp < k), the keys at or
    above it ranked by (key, lower flat position); a row that passes more
    keys than the buffer holds (``_k4_cap(k)``) goes through the radix select
    of the key's bytes instead. With ``with_counts`` also returns how many keys
    passed each row's threshold."""
    b, n = scores.shape
    kp = gidx.shape[1]
    if not 1 <= k <= kp * GROUP:
        raise ValueError(f"k={k} must be in [1, {kp * GROUP}]")
    cand, item = _candidate_plane(scores, gidx, packed_mask)
    pad = item >= n
    key = torch.where(pad, 0, order_key(cand))
    if kp >= k:
        gmax = key.view(b, kp, GROUP).amax(dim=2)
        t = torch.sort(gmax, dim=1, descending=True).values[:, k - 1 : k]
    else:
        t = torch.zeros(b, 1, dtype=torch.int64, device=key.device)
    passed = key >= t
    counts = passed.sum(dim=1)
    if bool((counts < k).any()):
        raise AssertionError("fewer than k keys at or above the threshold")
    exact, _ = _radix_topk(key, k, 2 if scores.dtype == torch.bfloat16 else 4)
    taken = torch.where((counts > _k4_cap(k))[:, None], exact, passed)
    pos = torch.arange(kp * GROUP, device=key.device)
    word = torch.where(taken, (key << 31) | (0x7FFFFFFF - pos), -1)
    top = 0x7FFFFFFF - (torch.sort(word, dim=1, descending=True).values[:, :k] & 0x7FFFFFFF)
    idx = item.gather(1, top)
    out = cand.gather(1, top), torch.where(idx < n, idx, -1)
    return (*out, counts) if with_counts else out


def candidate_extract(scores, gidx, k: int, packed_mask=None):
    """K4: the exact top-k among each row's groups ``gidx`` ((b, kp) int32,
    kp <= MAX_EXTRACT_GROUPS) of 128 consecutive columns of ``scores`` ((b, n) float32 or
    bfloat16) → (values (b, k), item indices (b, k) int64).

    Equal values come lower flat position first; with ``gidx`` ascending in
    a row that is the lower item index. A group id outside [0, n_groups) is
    a pad slot; a pad slot and the columns past ``n`` in the last group are
    never listed: where a row has fewer than ``k`` real candidates its list
    ends in (-inf, -1)."""
    if gidx.dim() != 2 or gidx.shape[0] != scores.shape[0] or gidx.dtype != torch.int32 or gidx.device != scores.device:
        raise ValueError(f"gidx must be an int32 ({scores.shape[0]}, kp) tensor on the scores' device")
    kp = gidx.shape[1]
    if not 1 <= kp <= MAX_EXTRACT_GROUPS:
        raise ValueError(f"gidx has {kp} groups a row; the kernel takes 1 to {MAX_EXTRACT_GROUPS}")
    _check_scores(scores, k, kp * GROUP)
    if scores.is_cpu:
        return candidate_extract_plain(scores, gidx, k, packed_mask)
    if not gidx.is_contiguous():
        raise ValueError("gidx must be contiguous")
    b, n = scores.shape
    mask_ptr, mask_stride = _mask_args(packed_mask, b, n, scores.device)
    vals = torch.empty(b, k, dtype=scores.dtype, device=scores.device)
    idx = torch.empty(b, k, dtype=torch.int64, device=scores.device)
    _build.launch(
        _EXTRACT_ENTRY[scores.dtype], "candidate_extract", scores.device,
        scores.data_ptr(), gidx.data_ptr(), mask_ptr, mask_stride, vals.data_ptr(), idx.data_ptr(), b, n, kp, k,
    )
    candidate_extract.launches += 1
    if k <= _K4_CAP:
        return vals, idx
    # past the buffer the kernel writes a row's k entries in no order, with
    # flat positions (a pad entry's past kp * 128): order them, then map
    # positions to items
    vals, pos = order_rows(vals, idx)
    kc = kp * GROUP
    item = gidx.long().gather(1, pos.clamp(max=kc - 1) // GROUP) * GROUP + pos % GROUP
    return vals, torch.where(pos < kc, item, -1)


def choose_groups(gmax, kp: int) -> torch.Tensor:
    """Each row's ``kp`` best groups of ``gmax`` ((b, n_groups) maxima),
    ranked by (maximum descending, group id ascending), as ascending int32
    ids: a superset of the groups that hold the row's top-k. On the card the
    ranking is K3's top-kp of the maxima, which orders by the same rule."""
    if gmax.is_cpu:
        return choose_groups_by_sort(gmax, kp)
    return torch.sort(_masked_topk(gmax.contiguous(), kp)[1].to(torch.int32), dim=1).values


def choose_groups_by_sort(gmax, kp: int) -> torch.Tensor:
    """The same by a full stable descending sort of the maxima, its first
    ``kp`` ids sorted ascending: ``choose_groups``' CPU body."""
    ranked = torch.sort(gmax, dim=1, descending=True, stable=True).indices[:, :kp]
    return torch.sort(ranked, dim=1).values.to(torch.int32)


def masked_group_max_plain(scores, packed_mask=None) -> torch.Tensor:
    """A masked copy, a padded copy and ``amax`` over (b, n_groups, 128)."""
    b, n = scores.shape
    ng = -(-n // GROUP)
    masked = scores if packed_mask is None else scores.masked_fill(unpack_mask(packed_mask, n), float("-inf"))
    masked = torch.nn.functional.pad(masked, (0, ng * GROUP - n), value=float("-inf"))
    return masked.view(b, ng, GROUP).float().amax(dim=2)


def masked_group_max(scores, packed_mask=None) -> torch.Tensor:
    """(b, n_groups) float32 maxima of each 128-column group, excluded
    columns and the columns past the row's end at ``-inf``. The maximum is
    taken in float32, which every bfloat16 fits exactly; a NaN is the
    maximum of its group, and a zero maximum may come out as ``-0`` (the
    plain version) or ``+0`` (the kernel)."""
    if scores.is_cpu:
        return masked_group_max_plain(scores, packed_mask)
    _check_scores(scores, 1, scores.shape[1])
    b, n = scores.shape
    mask_ptr, mask_stride = _mask_args(packed_mask, b, n, scores.device)
    out = torch.empty(b, -(-n // GROUP), dtype=torch.float32, device=scores.device)
    _build.launch(
        _FOLD_ENTRY[scores.dtype], "masked_group_max", scores.device,
        scores.data_ptr(), mask_ptr, mask_stride, out.data_ptr(), b, n,
    )
    masked_group_max.launches += 1
    return out


def _two_stage_topk(scores, k: int, packed_mask=None):
    """The masked group maxima, the choice of groups, then K4."""
    gmax = masked_group_max(scores, packed_mask)
    return candidate_extract(scores, choose_groups(gmax, min(k, gmax.shape[1])), k, packed_mask)


def takes_two_stage(n: int, k: int) -> bool:
    """The route rule of ``grouped_topk`` for a row of ``n`` columns: the
    two-stage route (K4) where ``GENMMREC_PALLAS_TOPK`` is set, the row has
    more than ``2k`` groups (the reference's narrow-row rule) and K4 holds
    the ``k`` groups it then takes; else K3 on the whole row."""
    return bool(os.environ.get("GENMMREC_PALLAS_TOPK")) and -(-n // GROUP) > 2 * k and k <= MAX_EXTRACT_GROUPS


def grouped_topk(scores, k: int, packed_mask=None):
    """Exact masked top-k of a 2-D float32 or bfloat16 score matrix →
    (values, indices)."""
    if scores.dim() == 2 and takes_two_stage(scores.shape[1], k):
        _check_scores(scores, k, scores.shape[1])
        return _two_stage_topk(scores, k, packed_mask)
    if scores.is_cpu:
        return grouped_topk_plain(scores, k, packed_mask)
    return _masked_topk(scores, k, packed_mask)


grouped_topk.launches = 0
candidate_extract.launches = 0
masked_group_max.launches = 0
