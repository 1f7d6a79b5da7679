"""K5: fused score + mask + top-k of the bf16 full-catalog evaluation.

Counterpart of ``genmmrec_tpu/ops/fused_topk.py`` ``fused_grouped_topk``:
the exact masked top-k of ``u_emb @ item_embᵀ`` in bfloat16 without writing
the (B, n_items) score plane. The catalog is cut into groups of 128 items:

1. K5a ``fused_group_max``: every score, train positives at ``-inf``, folded
   to one maximum per (row, group) → (B, n_groups) bfloat16;
2. K3 on the maxima (``choose_groups``; a sort on the CPU) picks each row's
   ``min(k, n_groups)`` best groups, a superset of the groups that hold the
   row's top-k;
3. K5b ``fused_candidates`` computes those groups' scores again with the
   mask applied → (B, kp·128) bfloat16. With ``cand_mask="external"`` K5c
   ``fused_candidates_unmasked`` leaves the mask out and ``external_mask``
   applies it in plain PyTorch. On the card both go group by group: a plan
   (``candidate_plan``; plain version ``candidate_plan_plain``) lists for
   each group the (row, slot) pairs that chose it, and a block multiplies one
   group's table tile by up to 128 of those rows;
4. K3 (``ops/topk.py``) takes the exact top-k of the candidates.

The three kernels are ``genmmrec_tpu_torch/csrc/fused_topk.cu``; its source
says what bounds them and how they are laid out. A score is
``bf16(Σ u·t)``: bfloat16 operands, float32 accumulation, one rounding.

Contract, as ``ops/topk.py``: values descending, the lower item index first
among equal values, excluded items and pad slots at ``-inf``. For the tie
rule to hold through the two stages, the groups are ranked by (maximum
descending, group id ascending) and the chosen ones are handed on sorted by
group id, so that a lower position in the candidate plane is a lower item
index. The JAX function orders ties by group rank instead, and shows
``finfo(bfloat16).min`` where this one shows ``-inf``.

``packed_mask`` is the plain little-endian bit matrix of
``Trainer._dense_mask``: (B, n_groups·16) uint8, bit ``j & 7`` of byte
``j >> 3`` set to exclude item ``j``, the columns past the catalog set. The
JAX package's planar layout is a TPU layout and has no counterpart here.

Each wrapper takes its plain PyTorch version (``*_plain``, which builds the
score plane) for tensors on the CPU and launches its kernel for CUDA
tensors, or raises.
"""

from __future__ import annotations

import torch

from genmmrec_tpu_torch.ops import _build
from genmmrec_tpu_torch.ops.topk import GROUP, choose_groups, grouped_topk, unpack_mask

# embedding widths the kernels are built for; a narrower one is padded with
# zero columns up to the next of these, which leaves every score unchanged
KERNEL_WIDTHS = (32, 64, 128)
NEG_INF = float("-inf")


def n_groups_for(n_items: int) -> int:
    return -(-n_items // GROUP)


def score_plane(u_emb, item_emb) -> torch.Tensor:
    """(B, n) bfloat16 scores: bfloat16 operands, float32 sums, one rounding."""
    u32, t32 = u_emb.bfloat16().float(), item_emb.bfloat16().float()
    return (u32 @ t32.T).bfloat16()


def _grouped_plane(u_emb, item_emb, packed_mask=None) -> torch.Tensor:
    """The score plane as (B, n_groups + 1, 128): columns past the catalog
    score 0 (a zero table row), the last group is the pad slot at ``-inf``,
    and the mask's bits, where given, are applied."""
    b, n = u_emb.shape[0], item_emb.shape[0]
    ng = n_groups_for(n)
    plane = torch.nn.functional.pad(score_plane(u_emb, item_emb), (0, ng * GROUP - n))
    if packed_mask is not None:
        plane = plane.masked_fill(unpack_mask(packed_mask, ng * GROUP), NEG_INF)
    plane = torch.nn.functional.pad(plane, (0, GROUP), value=NEG_INF)
    return plane.view(b, ng + 1, GROUP)


def fused_group_max_plain(u_emb, item_emb, packed_mask) -> torch.Tensor:
    groups = _grouped_plane(u_emb, item_emb, packed_mask)[:, :-1]
    return groups.float().amax(dim=2).bfloat16()


# K5a's work plan (``fold_work`` of the source): rows of u a unit keeps in
# shared memory (128 a consumer warpgroup, four of them), and the SMs of an
# H100 SXM, whose count the kernel reads from the device
FOLD_UNIT_ROWS = 512
H100_SMS = 132


def fold_work_plan(b: int, n_groups: int, sms: int = H100_SMS):
    """K5a's persistent grid as the kernel's host side cuts it → (grid,
    units): each unit (r0, r1, g0, g1) ``FOLD_UNIT_ROWS`` rows (the last
    cut at b) and a chunk of the groups, in the kernel's unit order (group
    chunk fastest); the groups are cut into as many chunks as the SMs allow
    beside the rows' chunks. Block x takes units x, x + grid, ...."""
    cdiv = lambda a, c: -(-a // c)
    row_chunks = cdiv(b, FOLD_UNIT_ROWS)
    unit_groups = cdiv(n_groups, max(1, min(n_groups, sms // row_chunks)))
    group_chunks = cdiv(n_groups, unit_groups)
    units = []
    for u in range(group_chunks * row_chunks):
        g0, r0 = (u % group_chunks) * unit_groups, (u // group_chunks) * FOLD_UNIT_ROWS
        units.append((r0, min(b, r0 + FOLD_UNIT_ROWS), g0, min(n_groups, g0 + unit_groups)))
    return min(len(units), sms), units


def fold_mask_word(group_bytes, t: int) -> torch.Tensor:
    """The 32-bit mask word of thread ``t`` (0..3 in its quad) from a group's
    16 mask bytes ((..., 16) uint8), as K5a forms it once per row and group:
    each 4-byte word shifted right by 2t, its bytes' low two bits kept, the
    four interleaved, so that bit ``fold_mask_bit(j, c)`` is the bit of the
    thread's column c of n-tile j (item 8j + 2t + c). int64 values."""
    w = group_bytes.to(torch.int64).view(*group_bytes.shape[:-1], 4, 4)
    w = (w << (8 * torch.arange(4))).sum(-1)  # little-endian 32-bit words
    x = (w >> (2 * t)) & 0x03030303
    return (x << (2 * torch.arange(4))).sum(-1)


def fold_mask_bit(j: int, c: int) -> int:
    return 8 * (j & 3) + 2 * (j >> 2) + c


def fused_group_max_tiled_plain(u_emb, item_emb, packed_mask, *, sms: int = H100_SMS):
    """K5a's arithmetic as the kernel runs it, in plain PyTorch on the CPU:
    the embedding width padded as the wrapper pads it; the float32 sums of a
    (row, group); each thread's 32 columns masked by its mask word and folded
    to their float32 maximum (-inf if none is left), the quad's four maxima
    folded, one rounding to bfloat16; every (row, group) written by the unit
    of ``fold_work_plan`` that owns it. Raises if a unit leaves one unwritten
    or writes one twice, and for a tensor on a CUDA device (the kernel's
    place)."""
    if not u_emb.is_cpu:
        raise ValueError("fused_group_max_tiled_plain mirrors the kernel on the CPU; the card runs the kernel")
    b, d = u_emb.shape
    n = item_emb.shape[0]
    ng = n_groups_for(n)
    width = next(w for w in KERNEL_WIDTHS if w >= d)
    u = torch.nn.functional.pad(u_emb.bfloat16(), (0, width - d)).float()
    t = torch.nn.functional.pad(item_emb.bfloat16(), (0, width - d, 0, ng * GROUP - n)).float()  # zero rows past n
    sums = (u @ t.T).view(b, ng, 16, 4, 2)  # (row, group, n-tile j, thread t, column c)
    group_bytes = packed_mask.view(b, ng, 16)
    bit = torch.tensor([[fold_mask_bit(j, c) for c in range(2)] for j in range(16)])
    words = torch.stack([fold_mask_word(group_bytes, q) for q in range(4)], dim=-1)  # (row, group, thread)
    excluded = ((words[:, :, None, :, None] >> bit[None, None, :, None, :]) & 1).bool()
    thread_max = sums.masked_fill(excluded, NEG_INF).amax(dim=(2, 4))  # (row, group, thread)
    folded = thread_max.amax(dim=2).bfloat16()  # the quad's maximum, rounded once
    out = torch.full((b, ng), float("nan"), dtype=torch.bfloat16)
    written = torch.zeros(b, ng, dtype=torch.int32)
    for r0, r1, g0, g1 in fold_work_plan(b, ng, sms)[1]:
        out[r0:r1, g0:g1] = folded[r0:r1, g0:g1]
        written[r0:r1, g0:g1] += 1
    if not bool((written == 1).all()):
        raise AssertionError("K5a's work plan leaves a (row, group) unwritten or writes one twice")
    return out


def _gather_groups(groups, gidx) -> torch.Tensor:
    b, ng1, _ = groups.shape
    slot = torch.where((gidx < 0) | (gidx >= ng1 - 1), ng1 - 1, gidx).long()
    return groups.gather(1, slot[:, :, None].expand(b, gidx.shape[1], GROUP)).reshape(b, -1)


def fused_candidates_plain(u_emb, item_emb, gidx, packed_mask) -> torch.Tensor:
    return _gather_groups(_grouped_plane(u_emb, item_emb, packed_mask), gidx)


def fused_candidates_unmasked_plain(u_emb, item_emb, gidx) -> torch.Tensor:
    return _gather_groups(_grouped_plane(u_emb, item_emb), gidx)


# slots of a work item of K5b and K5c: a group and up to this many of the
# slots that chose it
PLAN_ROWS = 128


def _max_items(b: int, kp: int, n_groups: int) -> int:
    """Work items the plan can make at most (the kernels' fixed grid)."""
    return -(-b * kp // PLAN_ROWS) + n_groups


def candidate_plan_plain(gidx, n_groups: int):
    """The plan of K5b and K5c: the flat slots ``r·kp + j`` of ``gidx``
    ((B, kp) group ids) inverted into one list a group by a stable counting
    sort, each list padded to whole work items of ``PLAN_ROWS`` slots →
    (item_group (max_items,) int32, slots (max_items·PLAN_ROWS,) int32).
    Work item w holds group ``item_group[w]``'s slots ``slots[w·PLAN_ROWS
    ...]``, a prefix of them real, the rest -1; the groups' items come in
    group order and past the last item ``item_group`` is -1. Pad slots (an
    id outside [0, n_groups)) join no list. The kernels' plan holds the same
    lists, each in an order of its own."""
    b, kp = gidx.shape
    dev = gidx.device
    flat = gidx.reshape(-1).long()
    real = (flat >= 0) & (flat < n_groups)
    counts = torch.bincount(flat[real], minlength=n_groups)
    items = -(-counts // PLAN_ROWS)
    first_item = torch.cumsum(items, 0) - items
    max_items = _max_items(b, kp, n_groups)
    item_group = torch.full((max_items,), -1, dtype=torch.int32, device=dev)
    item_group[: int(items.sum())] = torch.repeat_interleave(torch.arange(n_groups, device=dev), items).int()
    order = torch.sort(torch.where(real, flat, n_groups), stable=True).indices[: int(counts.sum())]
    group = flat[order]
    rank = torch.arange(len(order), device=dev) - (torch.cumsum(counts, 0) - counts)[group]
    slots = torch.full((max_items * PLAN_ROWS,), -1, dtype=torch.int32, device=dev)
    slots[first_item[group] * PLAN_ROWS + rank] = order.int()
    return item_group, slots


def _plan_layout(b: int, kp: int, n_groups: int) -> tuple[int, int]:
    """(int32 words of the plan's scratch, where its item_group starts), as
    ``struct Plan`` of the source lays it out: counters and each group's
    first work item, then item_group and the padded list."""
    at = 3 * n_groups + 2
    return at + _max_items(b, kp, n_groups) * (1 + PLAN_ROWS), at


def _check_gidx(gidx, b: int, device):
    if gidx.dim() != 2 or gidx.shape[0] != b or gidx.dtype != torch.int32 or gidx.device != device or not gidx.is_contiguous():
        raise ValueError(f"gidx must be a contiguous int32 ({b}, kp) tensor on the operands' device")


def candidate_plan(gidx, n_groups: int):
    """The plan as the kernels build it (the stage that K5b and K5c run
    first, alone, for its checks and its time): (item_group, slots) in
    ``candidate_plan_plain``'s layout, each list's slots in an order of the
    kernel's own. The plain version for a tensor on the CPU."""
    if gidx.is_cpu:
        return candidate_plan_plain(gidx, n_groups)
    b = gidx.shape[0]
    _check_gidx(gidx, b, gidx.device)
    kp = gidx.shape[1]
    words, at = _plan_layout(b, kp, n_groups)
    scratch = torch.empty(words, dtype=torch.int32, device=gidx.device)
    _build.launch(
        "fused_candidate_plan", "candidate_plan", gidx.device,
        gidx.data_ptr(), scratch.data_ptr(), scratch.numel(), b, n_groups, kp,
    )
    items = _max_items(b, kp, n_groups)
    return scratch[at : at + items], scratch[at + items :]


def external_mask(cand, gidx, packed_mask) -> torch.Tensor:
    """The mask's bits applied to unmasked candidates, in plain PyTorch (as
    ``_external_mask`` of the JAX package is plain XLA): each chosen group's
    16 mask bytes are gathered and unpacked; a pad slot is excluded whole."""
    b, kp = gidx.shape
    ng = packed_mask.shape[1] // (GROUP // 8)
    pad = (gidx < 0) | (gidx >= ng)
    slot = torch.where(pad, 0, gidx).long()
    group_bytes = packed_mask.view(b, ng, GROUP // 8).gather(1, slot[:, :, None].expand(b, kp, GROUP // 8))
    excluded = unpack_mask(group_bytes.reshape(b, -1), kp * GROUP) | pad.repeat_interleave(GROUP, dim=1)
    return cand.masked_fill(excluded, NEG_INF)


def _check_operands(u_emb, item_emb, packed_mask=None):
    """The kernels' operands: bfloat16, contiguous, 16-byte aligned, on one
    CUDA device; the embedding width padded with zero columns to one the
    kernels are built for. Returns (u, table, b, n, d)."""
    if u_emb.dim() != 2 or item_emb.dim() != 2 or u_emb.shape[1] != item_emb.shape[1]:
        raise ValueError(f"u_emb {tuple(u_emb.shape)} and item_emb {tuple(item_emb.shape)} must be (B, d) and (n, d)")
    if u_emb.dtype != torch.bfloat16 or item_emb.dtype != torch.bfloat16 or item_emb.device != u_emb.device:
        raise ValueError("u_emb and item_emb must be bfloat16 tensors on one device")
    b, d = u_emb.shape
    n = item_emb.shape[0]
    if n < 1:
        raise ValueError("item_emb has no rows")
    width = next((w for w in KERNEL_WIDTHS if w >= d), None)
    if width is None:
        raise ValueError(f"embedding width {d} exceeds the kernels' widest, {KERNEL_WIDTHS[-1]}")
    if width != d:
        u_emb = torch.nn.functional.pad(u_emb, (0, width - d))
        item_emb = torch.nn.functional.pad(item_emb, (0, width - d))
    if packed_mask is not None:
        want = (b, n_groups_for(n) * (GROUP // 8))
        if (
            packed_mask.device != u_emb.device
            or packed_mask.dtype != torch.uint8
            or tuple(packed_mask.shape) != want
            or not packed_mask.is_contiguous()
            or packed_mask.data_ptr() % 16
        ):
            raise ValueError(f"packed_mask must be a contiguous, 16-byte aligned uint8 {want} tensor")
    u, table = u_emb.contiguous(), item_emb.contiguous()
    # the kernels' tensor maps (TMA) read from 16-byte aligned addresses; a
    # row's width (64, 128 or 256 bytes) keeps every row aligned
    if u.data_ptr() % 16 or table.data_ptr() % 16:
        raise ValueError("u_emb and item_emb must start on 16-byte aligned addresses")
    return u, table, b, n, width


def fused_group_max(u_emb, item_emb, packed_mask) -> torch.Tensor:
    """K5a: (B, n_groups) bfloat16 maxima of each 128-item group's masked scores."""
    if u_emb.is_cpu:
        return fused_group_max_plain(u_emb, item_emb, packed_mask)
    if packed_mask is None:
        raise ValueError("fused_group_max needs the packed mask (its pad columns exclude the catalog's tail)")
    u, table, b, n, d = _check_operands(u_emb, item_emb, packed_mask)
    gmax = torch.empty(b, n_groups_for(n), dtype=torch.bfloat16, device=u.device)
    _build.launch(
        "fused_group_max_bf16", "fused_group_max", u.device,
        u.data_ptr(), table.data_ptr(), packed_mask.data_ptr(), gmax.data_ptr(), b, n, d,
    )
    fused_group_max.launches += 1
    return gmax


def _launch_candidates(entry: str, u_emb, item_emb, gidx, packed_mask):
    u, table, b, n, d = _check_operands(u_emb, item_emb, packed_mask)
    _check_gidx(gidx, b, u.device)
    kp = gidx.shape[1]
    cand = torch.empty(b, kp * GROUP, dtype=torch.bfloat16, device=u.device)
    scratch = torch.empty(_plan_layout(b, kp, n_groups_for(n))[0], dtype=torch.int32, device=u.device)
    _build.launch(
        entry, entry, u.device,
        u.data_ptr(), table.data_ptr(), gidx.data_ptr(),
        None if packed_mask is None else packed_mask.data_ptr(), cand.data_ptr(),
        scratch.data_ptr(), scratch.numel(), b, n, d, kp,
    )
    return cand


def fused_candidates(u_emb, item_emb, gidx, packed_mask) -> torch.Tensor:
    """K5b: (B, kp·128) bfloat16 scores of each row's groups ``gidx`` ((B, kp)
    int32), excluded items at ``-inf``; a group id outside [0, n_groups) is
    a pad slot of ``-inf``."""
    if u_emb.is_cpu:
        return fused_candidates_plain(u_emb, item_emb, gidx, packed_mask)
    if packed_mask is None:
        raise ValueError("fused_candidates needs the packed mask; fused_candidates_unmasked takes none")
    cand = _launch_candidates("fused_candidates_bf16", u_emb, item_emb, gidx, packed_mask)
    fused_candidates.launches += 1
    return cand


def fused_candidates_unmasked(u_emb, item_emb, gidx) -> torch.Tensor:
    """K5c: as ``fused_candidates`` without the mask; ``external_mask``
    applies it afterwards."""
    if u_emb.is_cpu:
        return fused_candidates_unmasked_plain(u_emb, item_emb, gidx)
    cand = _launch_candidates("fused_candidates_unmasked_bf16", u_emb, item_emb, gidx, None)
    fused_candidates_unmasked.launches += 1
    return cand


fused_group_max.launches = 0
fused_candidates.launches = 0
fused_candidates_unmasked.launches = 0


def fused_grouped_topk(u_emb, item_emb, k: int, packed_mask, *, cand_mask: str = "kernel"):
    """Exact masked top-k of ``u_emb @ item_embᵀ`` scored in bfloat16 →
    (values (B, k) bfloat16, indices (B, k) int64 into the catalog).

    ``u_emb`` (B, d) and ``item_emb`` (n_items, d) may be any float type and
    are cast to bfloat16. ``cand_mask`` is ``"kernel"`` (K5b applies the
    mask; the JAX function's ``"mxu"``) or ``"external"`` (K5c, then
    ``external_mask``); both give the same result bit for bit.
    """
    if cand_mask not in ("kernel", "external"):
        raise ValueError(f"cand_mask must be 'kernel' or 'external', not {cand_mask!r}")
    n = item_emb.shape[0]
    if not 1 <= k <= n:
        raise ValueError(f"k={k} must be in [1, {n}]")
    u, table = u_emb.bfloat16(), item_emb.bfloat16()
    gmax = fused_group_max(u, table, packed_mask)
    # a catalog of fewer than k groups hands all of them on; on the card K3
    # chooses them, as on the two-stage route (faster than a full sort of the
    # maxima: chip_smoke.py check_k5)
    gidx = choose_groups(gmax, min(k, gmax.shape[1]))
    if cand_mask == "external":
        cand = external_mask(fused_candidates_unmasked(u, table, gidx), gidx, packed_mask)
    else:
        cand = fused_candidates(u, table, gidx, packed_mask)
    vals, pos = grouped_topk(cand, k)
    idx = gidx.long().gather(1, pos // GROUP) * GROUP + pos % GROUP
    return vals, idx
