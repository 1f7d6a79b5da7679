"""What the H100 design of K4 and its fold keep in Python, on the CPU.

K4's selection, mirrored step by step in PyTorch
(``candidate_extract_selection_plain``: the candidates' keys, the chosen
groups' maxima, the threshold, one ranking, the radix select on overflow),
against ``candidate_extract_plain`` and the JAX Pallas kernel
``_candidate_extract_pallas`` in interpret mode, on seeded rows and on rows
that defeat the threshold: indices equal exactly, values equal (a NaN to a
NaN); odd numbers of chosen groups, DiffMM's top-1 among them. The switched
two-stage route with its groups chosen by K3's selection
(``grouped_topk_selection_plain`` on the maxima, as the card does) against
``lax.top_k`` of the masked row. ``masked_group_max`` with NaNs, zeros of
both signs, excluded groups and a ragged tail against the JAX fold.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genmmrec_tpu.ops.topk import _candidate_extract_pallas, _unpack_bits
from genmmrec_tpu_torch.ops import topk as T

GROUP = 128
_t = torch.from_numpy


def _same(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return a.shape == b.shape and bool(((a == b) | (np.isnan(a) & np.isnan(b))).all())


def _rows(b, n, per_row, seed):
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((b, n)).astype(np.float32)
    dense = np.zeros((b, n), bool)
    for r in range(b):
        dense[r, rng.choice(n, size=per_row, replace=False)] = True
    return rng, s, dense


def _jax_plane(s, dense, dtype):
    """The finite-sentinel masked plane (b, g, 128) the JAX route hands its kernel."""
    b, n = s.shape
    ng = -(-n // GROUP)
    neg_fin = float(jnp.finfo(dtype).min)
    plane = np.full((b, ng * GROUP), neg_fin, np.float32)
    plane[:, :n] = np.where(dense, neg_fin, s)
    return jnp.asarray(plane).astype(dtype).reshape(b, ng, GROUP)


def _dtypes(dtype):
    return (torch.float32, jnp.float32) if dtype == "float32" else (torch.bfloat16, jnp.bfloat16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_k4_selection_matches_plain_and_the_pallas_kernel(dtype, masked):
    """The evaluation's case at a small batch: 63,001 columns (a last group
    of 25), 30 positives a row, kp = k = 50. The threshold path serves every
    row (a few more than k keys pass), and the lists equal the plain
    version's and the Pallas kernel's on the same groups."""
    b, n, k = 12, 63001, 50
    _, s, dense = _rows(b, n, 30, seed=17)
    if not masked:
        dense[:] = False
    tdt, jdt = _dtypes(dtype)
    ts = _t(s).to(tdt)
    mask = _t(np.packbits(dense, axis=1, bitorder="little")) if masked else None
    gidx = T.choose_groups(T.masked_group_max(ts, mask), k)
    v, i, counts = T.candidate_extract_selection_plain(ts, gidx, k, mask, with_counts=True)
    assert bool((counts >= k).all()) and bool((counts <= T._k4_cap(k)).all()) and int(counts.max()) < 2 * k
    v_ref, i_ref = T.candidate_extract_plain(ts, gidx, k, mask)
    assert torch.equal(i, i_ref) and torch.equal(v, v_ref) and v.dtype == tdt
    v_j, i_j = _candidate_extract_pallas(
        _jax_plane(ts.float().numpy(), dense, jdt), jnp.asarray(gidx.numpy()), k, GROUP, interpret=True
    )
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(v.float().numpy(), np.asarray(v_j, np.float32))


def _adversarial(kind, dtype):
    """(scores, packed mask, groups, k, whether the row must overflow the
    buffer) for one kind of row that defeats K4's threshold: 3,865 columns
    (30 full groups and a ragged one of 25), 6 rows."""
    b, n = 6, 30 * GROUP + 25
    ng = -(-n // GROUP)
    rng, s, dense = _rows(b, n, 20, seed=ADVERSARIAL.index(kind))
    k, kp, overflow = 20, 20, False
    if kind == "every_candidate_masked":
        dense[:] = True
        overflow = True
    elif kind == "constant":
        s[:] = 0.25
        overflow = True
    elif kind == "integer_tied_at_threshold":
        s = np.round(s * 2)  # a few values, each shared by many columns
    elif kind == "nan_and_zeros_of_both_signs":
        s = -np.abs(s)
        s[:, n // 3 : n // 2] = 0.0
        s[:, n // 3 : n // 2 : 2] = -0.0
        s[np.arange(b), rng.integers(0, n, b)] = np.nan
        overflow = True  # some 640 zeros tie at the threshold
    elif kind == "seven_finite":
        s[:, rng.permutation(n)[7:]] = -np.inf
        dense[:] = False
        overflow = True
    elif kind == "kp_above_k":
        kp = 28
    elif kind == "kp_below_k":
        k, kp, overflow = 300, 5, True  # 640 candidates all pass
    elif kind == "k_past_the_buffer":
        k, kp, overflow = T._K4_CAP + 88, 12, True
    ts = _t(s).to(_dtypes(dtype)[0])
    mask = _t(np.packbits(dense, axis=1, bitorder="little"))
    gidx = T.choose_groups(T.masked_group_max(ts, mask), kp)
    if kind == "pad_slots_and_the_ragged_group":
        # a pad slot past the catalog, one below 0, the ragged last group
        gidx[:, -1] = ng
        gidx[::2, 0] = -1
        gidx[1::2, kp // 2] = ng - 1
        gidx = gidx.sort(dim=1).values
        k = kp * GROUP - 200  # rows run out of real candidates
        overflow = True
    return ts, mask, gidx, k, overflow


ADVERSARIAL = [
    "every_candidate_masked", "constant", "integer_tied_at_threshold", "nan_and_zeros_of_both_signs",
    "seven_finite", "pad_slots_and_the_ragged_group", "kp_above_k", "kp_below_k", "k_past_the_buffer",
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ADVERSARIAL)
def test_k4_selection_on_adversarial_rows(kind, dtype):
    """Each kind through the threshold or, where more keys pass than the
    buffer holds, the radix select: the same lists as the plain version,
    pad entries never listed before a real one."""
    ts, mask, gidx, k, overflow = _adversarial(kind, dtype)
    v, i, counts = T.candidate_extract_selection_plain(ts, gidx, k, mask, with_counts=True)
    assert bool(((counts > T._k4_cap(k)) == overflow).all())  # which path each row takes
    v_ref, i_ref = T.candidate_extract_plain(ts, gidx, k, mask)
    assert torch.equal(i, i_ref)
    assert _same(v.float(), v_ref.float())
    # a -1 is followed by -1 only
    pad = (i < 0).numpy()
    assert not (pad[:, :-1] & ~pad[:, 1:]).any()
    if kind == "pad_slots_and_the_ragged_group":
        assert pad.any() and bool(torch.isinf(v[torch.from_numpy(pad)]).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k4_selection_on_tied_rows_matches_the_pallas_kernel(dtype):
    """Integer-valued rows tied at the threshold and constant rows, kp = k:
    the Pallas kernel also takes the lowest flat position among equal
    values, so its lists are the mirrored selection's."""
    tdt, jdt = _dtypes(dtype)
    rng = np.random.default_rng(5)
    b, n, k = 8, 40 * GROUP, 24
    s = np.round(rng.standard_normal((b, n)) * 2).astype(np.float32)
    s[::3] = 1.0
    dense = np.zeros((b, n), bool)
    ts = _t(s).to(tdt)
    gidx = T.choose_groups(T.masked_group_max(ts), k)
    v, i = T.candidate_extract_selection_plain(ts, gidx, k)
    v_j, i_j = _candidate_extract_pallas(
        _jax_plane(ts.float().numpy(), dense, jdt), jnp.asarray(gidx.numpy()), k, GROUP, interpret=True
    )
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(v.float().numpy(), np.asarray(v_j, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,kp", [(1, 1), (7, 7), (25, 25), (7, 25)])
def test_k4_selection_at_odd_kp(k, kp, dtype):
    """Odd numbers of chosen groups, DiffMM's top-1 (kp = k = 1) among them,
    on masked rows of 30 groups and a ragged one: the mirrored selection
    equals the plain version and, where kp = k, the Pallas kernel."""
    b, n = 8, 30 * GROUP + 25
    _, s, dense = _rows(b, n, 20, seed=100 + k + kp)
    tdt, jdt = _dtypes(dtype)
    ts = _t(s).to(tdt)
    mask = _t(np.packbits(dense, axis=1, bitorder="little"))
    gidx = T.choose_groups(T.masked_group_max(ts, mask), kp)
    v, i, counts = T.candidate_extract_selection_plain(ts, gidx, k, mask, with_counts=True)
    assert bool((counts >= k).all())
    v_ref, i_ref = T.candidate_extract_plain(ts, gidx, k, mask)
    assert torch.equal(i, i_ref) and torch.equal(v, v_ref)
    if kp == k:
        v_j, i_j = _candidate_extract_pallas(
            _jax_plane(ts.float().numpy(), dense, jdt), jnp.asarray(gidx.numpy()), k, GROUP, interpret=True
        )
        np.testing.assert_array_equal(i.numpy(), np.asarray(i_j))
        np.testing.assert_array_equal(v.float().numpy(), np.asarray(v_j, np.float32))


def _k3_choice(gmax, kp):
    """The card's choice of groups: K3's selection on the maxima, the ids
    sorted ascending."""
    return torch.sort(T.grouped_topk_selection_plain(gmax, kp)[1], dim=1).values.to(torch.int32)


@pytest.mark.parametrize(
    "b,n,k,dtype,masked",
    [
        (16, 63001, 50, "float32", True),
        (16, 63001, 50, "bfloat16", True),
        (16, 63001, 50, "float32", False),
        (12, 26000, 100, "float32", True),  # kp = 100: K3's radix path on the maxima
        (16, 13000, 7, "bfloat16", False),
        (16, 13000, 1, "float32", True),
    ],
)
def test_switched_route_with_k3_choosing_the_groups_matches_lax_top_k(monkeypatch, b, n, k, dtype, masked):
    _, s, dense = _rows(b, n, 200, seed=n + k)
    if not masked:
        dense[:] = False
    tdt, jdt = _dtypes(dtype)
    ts = _t(s).to(tdt)
    mask = _t(np.packbits(dense, axis=1, bitorder="little")) if masked else None
    ref = jnp.asarray(ts.float().numpy()).astype(jdt)
    v_ref, i_ref = jax.lax.top_k(jnp.where(jnp.asarray(dense), -jnp.inf, ref), k)
    gmax = T.masked_group_max(ts, mask)
    assert torch.equal(_k3_choice(gmax, k), T.choose_groups(gmax, k))

    calls = []
    monkeypatch.setattr(T, "choose_groups", lambda g, kp: calls.append(kp) or _k3_choice(g, kp))
    monkeypatch.setattr(T, "candidate_extract", T.candidate_extract_selection_plain)
    monkeypatch.setenv("GENMMREC_PALLAS_TOPK", "1")
    v, i = T.grouped_topk(ts, k, mask)
    assert calls == [k]
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_array_equal(v.float().numpy(), np.asarray(v_ref, np.float32))


def _jax_fold(s, packed, n):
    """The reference's fold: the mask fused into the group maximum
    (``genmmrec_tpu/ops/topk.py`` ``grouped_topk``), the row padded at -inf."""
    b = s.shape[0]
    ng = -(-n // GROUP)
    s3 = jnp.pad(jnp.asarray(s), ((0, 0), (0, ng * GROUP - n)), constant_values=-jnp.inf).reshape(b, ng, GROUP)
    pm = jnp.pad(jnp.asarray(packed), ((0, 0), (0, ng * GROUP // 8 - packed.shape[1])))
    return jnp.where(_unpack_bits(pm.reshape(b, ng, GROUP // 8), GROUP), -jnp.inf, s3).max(axis=-1)


def _fold_by_key(ts, packed):
    """The kernel's rule: the largest order key of each group, mapped back
    to its float (a NaN wins, a zero comes out as +0)."""
    b, n = ts.shape
    ng = -(-n // GROUP)
    s = ts.masked_fill(T.unpack_mask(packed, n), float("-inf"))
    s = torch.nn.functional.pad(s.float(), (0, ng * GROUP - n), value=float("-inf"))
    key = T.order_key(s).view(b, ng, GROUP).amax(dim=2).numpy().astype(np.uint64)
    bits = np.where(key & 0x80000000, key & 0x7FFFFFFF, ~key & 0xFFFFFFFF).astype(np.uint32)
    return bits.view(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_group_max_matches_the_jax_fold(dtype):
    """NaNs (of both signs), zeros of both signs, a group whose columns are
    all excluded, a ragged last group of 25: equal after ``+ 0.0``, a NaN
    where the reference has one; the kernel's rule by keys gives the same."""
    b, n = 6, 20 * GROUP + 25
    rng, s, dense = _rows(b, n, 40, seed=3)
    s[0, 5] = np.nan
    s[1, 300] = -np.nan
    s[2] = -np.abs(s[2])
    s[2, : 3 * GROUP] = 0.0
    s[2, : 3 * GROUP : 3] = -0.0
    s[3, -25:] = 7.0  # the ragged group's maximum
    dense[4, GROUP : 3 * GROUP] = True  # two groups wholly excluded
    dense[5, :] = True
    tdt, jdt = _dtypes(dtype)
    ts = _t(s).to(tdt)
    packed = np.packbits(dense, axis=1, bitorder="little")
    got = (T.masked_group_max(ts, _t(packed)) + 0.0).numpy()
    want = np.asarray(_jax_fold(jnp.asarray(ts.float().numpy()).astype(jdt), packed, n), np.float32) + 0.0
    assert got.dtype == np.float32 and got.shape == (b, -(-n // GROUP))
    assert _same(got, want)
    assert np.isnan(got[0, 0]) and np.isnan(got[1, 2]) and got[3, -1] == 7.0
    assert np.isneginf(got[4, 1:3]).all() and np.isneginf(got[5]).all()
    assert _same(_fold_by_key(ts, _t(packed)), got)
