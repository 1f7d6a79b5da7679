"""The group-major design of K5b and K5c (``ops/fused_topk.py``), on the CPU.

On the card the candidates kernels first invert each row's choice of groups
into one list a group of the (row, slot) pairs that chose it (the plan),
then multiply one group's table tile by up to 128 of those rows at a time.
Held here: ``candidate_plan_plain`` against a numpy inversion, on rows with
pad slots, with one group chosen by every row and with no real slot; the
candidates computed group by group through the plan's lists (the kernels'
layout) equal to the row-major plain version bit for bit, masked and
unmasked, against the JAX package's stages too; and the wrappers hand the
kernel library a scratch of the plan's size.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genmmrec_tpu.ops.fused_topk import _external_mask, pack_planar_mask
from genmmrec_tpu_torch.ops import _build
from genmmrec_tpu_torch.ops import fused_topk as F


def _np_plan(gidx, n_groups, rows=F.PLAN_ROWS):
    """The inversion by a loop: each group's flat slots, ascending, cut into
    work items of ``rows`` slots, the last one of a group padded with -1."""
    flat = gidx.reshape(-1)
    max_items = -(-flat.size // rows) + n_groups
    item_group, slots = [], []
    for g in range(n_groups):
        listed = [s for s in range(flat.size) if flat[s] == g]
        for lo in range(0, len(listed), rows):
            part = listed[lo : lo + rows]
            item_group.append(g)
            slots += part + [-1] * (rows - len(part))
    item_group += [-1] * (max_items - len(item_group))
    slots += [-1] * (max_items * rows - len(slots))
    return np.array(item_group, np.int32), np.array(slots, np.int32)


def _gidx_cases():
    rng = np.random.default_rng(0)
    b, kp, ng = 9, 6, 11
    ranked = np.stack([np.sort(rng.permutation(ng)[:kp]) for _ in range(b)]).astype(np.int32)
    padded = ranked.copy()
    padded[:, -1] = ng  # the fused route's pad slot
    padded[::3, 0] = -1
    padded[4, 2] = ng + 7
    return {
        "ranked": (ranked, ng),
        "pad_slots": (padded, ng),
        "every_row_the_same_groups": (np.tile(ranked[:1], (b, 1)), ng),
        "one_group_chosen_by_every_row": (np.full((b, 1), 3, np.int32), ng),
        "all_pad_slots": (np.full((b, kp), ng, np.int32), ng),
        "one_row": (ranked[:1], ng),
    }


@pytest.mark.parametrize("case", list(_gidx_cases()))
def test_plan_plain_matches_numpy_inversion(case):
    gidx, ng = _gidx_cases()[case]
    item_group, slots = F.candidate_plan_plain(torch.from_numpy(gidx), ng)
    max_items = -(-gidx.size // F.PLAN_ROWS) + ng
    assert item_group.dtype == slots.dtype == torch.int32
    assert item_group.shape == (max_items,) and slots.shape == (max_items * F.PLAN_ROWS,)
    want_groups, want_slots = _np_plan(gidx, ng)
    np.testing.assert_array_equal(item_group.numpy(), want_groups)
    np.testing.assert_array_equal(slots.numpy(), want_slots)
    # every real slot once, in a work item of its own group
    real = (gidx >= 0) & (gidx < ng)
    listed = slots.numpy().reshape(max_items, F.PLAN_ROWS)
    assert (listed >= 0).sum() == real.sum()
    for w, g in enumerate(item_group.numpy()):
        assert (gidx.reshape(-1)[listed[w][listed[w] >= 0]] == g).all()
    # the CPU route of the kernels' plan is the plain one
    got = F.candidate_plan(torch.from_numpy(gidx), ng)
    assert torch.equal(got[0], item_group) and torch.equal(got[1], slots)


def test_plan_cuts_a_long_list_into_work_items_of_128():
    """A group chosen by 300 rows makes three work items (128, 128, 44): no
    block owns more than 128 rows."""
    gidx = np.full((300, 2), 5, np.int32)
    gidx[:, 1] = np.arange(300) % 4
    item_group, slots = F.candidate_plan_plain(torch.from_numpy(gidx), 6)
    per_item = (slots.view(-1, F.PLAN_ROWS) >= 0).sum(dim=1)
    assert item_group[item_group >= 0].tolist() == [0, 1, 2, 3, 5, 5, 5]
    assert per_item[:7].tolist() == [75, 75, 75, 75, 128, 128, 44] and int(per_item[7:].sum()) == 0


def _operands(b, n, d, seed):
    """Integer-valued operands: every score exact in bfloat16 in any order."""
    rng = np.random.default_rng(seed)
    u = rng.integers(-2, 3, (b, d)).astype(np.float32)
    t = rng.integers(-2, 3, (n, d)).astype(np.float32)
    dense = rng.random((b, n)) < 0.2
    full = np.ones((b, F.n_groups_for(n) * F.GROUP), bool)
    full[:, :n] = dense
    packed = np.packbits(full, axis=1, bitorder="little")
    return torch.from_numpy(u), torch.from_numpy(t), torch.from_numpy(packed), dense


def _group_major(u, t, gidx, packed):
    """The candidates as the kernels lay out their work: for each group, the
    rows of its list (128 at a time), each slot's 128 scores written once to
    its own run of the (B, kp·128) output; pad slots -inf."""
    b, kp = gidx.shape
    ng = F.n_groups_for(t.shape[0])
    item_group, slots = F.candidate_plan_plain(gidx, ng)
    plane = F._grouped_plane(u, t, packed)  # (B, ng + 1, 128), masked where packed is given
    out = torch.full((b * kp, F.GROUP), float("-inf"), dtype=torch.bfloat16)
    written = torch.zeros(b * kp, dtype=torch.int64)
    for w, g in enumerate(item_group.tolist()):
        if g < 0:
            break
        part = slots[w * F.PLAN_ROWS : (w + 1) * F.PLAN_ROWS].long()
        part = part[part >= 0]
        out[part] = plane[part // kp, g]
        written[part] += 1
    real = ((gidx >= 0) & (gidx < ng)).reshape(-1)
    assert torch.equal(written, real.long())  # each real slot once, pads never
    return out.view(b, kp * F.GROUP)


@pytest.mark.parametrize("masked", [True, False], ids=["K5b", "K5c"])
@pytest.mark.parametrize("case", ["ranked", "pad_slots", "every_row_the_same_groups", "one_group_chosen_by_every_row"])
def test_group_major_layout_equals_the_row_major_plain_version(case, masked):
    b, n, d = 300, 1300, 32  # 11 groups, a ragged last one of 20 items; lists past 128 rows
    gidx = _gidx_cases()[case][0]
    gidx = torch.from_numpy(np.resize(gidx, (b, gidx.shape[1])).astype(np.int32))
    u, t, packed, _ = _operands(b, n, d, seed=len(case))
    ub, tb = u.bfloat16(), t.bfloat16()
    if masked:
        ref = F.fused_candidates_plain(ub, tb, gidx, packed)
        assert torch.equal(F.fused_candidates(ub, tb, gidx, packed), ref)
    else:
        ref = F.fused_candidates_unmasked_plain(ub, tb, gidx)
        assert torch.equal(F.fused_candidates_unmasked(ub, tb, gidx), ref)
    assert torch.equal(_group_major(ub, tb, gidx, packed if masked else None), ref)


def test_group_major_candidates_match_jax_external_mask():
    """The group-major unmasked candidates with the JAX package's
    ``_external_mask`` applied (on the planar repacking of the same mask)
    equal the port's masked candidates: the two packages' masking agrees on
    the plan's layout."""
    b, n, d, kp = 7, 8692, 16, 9
    u, t, packed, dense = _operands(b, n, d, seed=5)
    ng = F.n_groups_for(n)
    rng = np.random.default_rng(6)
    gidx = torch.from_numpy(np.stack([np.sort(rng.permutation(ng)[:kp]) for _ in range(b)]).astype(np.int32))
    ub, tb = u.bfloat16(), t.bfloat16()
    raw = _group_major(ub, tb, gidx, None)
    ref = _external_mask(
        jnp.asarray(raw.float().numpy()).astype(jnp.bfloat16), jnp.asarray(gidx.numpy()),
        jnp.asarray(pack_planar_mask(dense)), group=F.GROUP, tn=8192,
    )
    ref = np.asarray(ref, np.float32)
    masked = _group_major(ub, tb, gidx, packed).float().numpy()
    np.testing.assert_array_equal(np.isinf(masked), ref == float(jnp.finfo(jnp.bfloat16).min))
    np.testing.assert_array_equal(masked[np.isfinite(masked)], ref[np.isfinite(masked)])


def test_wrappers_hand_the_kernels_a_scratch_of_the_plans_size(monkeypatch):
    """Off the CPU the candidates wrappers and the plan's wrapper go to the
    kernel library with a scratch of 3·n_groups + 2 + (ceil(B·kp / 128) +
    n_groups)·129 int32 words (the source's ``struct Plan``). Meta tensors
    take that route without a card."""
    meta = torch.device("meta")
    b, n, kp = 8, 700, 5
    ng = F.n_groups_for(n)
    u = torch.zeros(b, 64, dtype=torch.bfloat16, device=meta)
    t = torch.zeros(n, 64, dtype=torch.bfloat16, device=meta)
    mask = torch.zeros(b, ng * 16, dtype=torch.uint8, device=meta)
    gidx = torch.zeros(b, kp, dtype=torch.int32, device=meta)
    seen = []

    def launch(entry, what, device, *args):
        seen.append((entry, args))

    monkeypatch.setattr(_build, "launch", launch)
    F.fused_candidates(u, t, gidx, mask)
    F.fused_candidates_unmasked(u, t, gidx)
    item_group, slots = F.candidate_plan(gidx, ng)
    assert [e for e, _ in seen] == ["fused_candidates_bf16", "fused_candidates_unmasked_bf16", "fused_candidate_plan"]
    want = 3 * ng + 2 + (-(-b * kp // 128) + ng) * 129
    for entry, args in seen[:2]:
        assert args[6:] == (want, b, n, 64, kp)
    assert seen[2][1][2:] == (want, b, ng, kp)
    items = -(-b * kp // 128) + ng
    assert item_group.shape == (items,) and slots.shape == (items * 128,)
    with pytest.raises(ValueError, match="gidx"):
        F.candidate_plan(gidx.long(), ng)
