"""The port's fused score + mask + top-k (``genmmrec_tpu_torch/ops/fused_topk.py``)
against the JAX package's ``fused_grouped_topk`` (Pallas in interpret mode)
and against numpy oracles, on the CPU.

On the CPU the port's wrappers run their plain PyTorch versions. The same
bool mask is packed planar for the JAX function and plain little-endian for
the port. Two kinds of operands:

- integer-valued (entries in {-2..2}): every score is an integer of
  magnitude <= 4·d, exact in bfloat16 in any order of summation, so values
  must be equal bit for bit and ties are common;
- Gaussian: two float32 sums of the same terms in another order may round
  to either side of a bfloat16 boundary, so values are held to one bfloat16
  ulp and index lists may differ only across ties or one-ulp neighbours.

Masked entries surface as ``-inf`` in the port and as ``finfo(bfloat16).min``
in the JAX function; among equal values the port lists the lower item index
first (``lax.top_k``'s rule on the plane), the JAX function the group that
ranked higher.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genmmrec_tpu.ops.fused_topk import TILE_N, _external_mask, pack_planar_mask
from genmmrec_tpu.ops.fused_topk import fused_grouped_topk as j_fused
from genmmrec_tpu_torch.ops import _build
from genmmrec_tpu_torch.ops import fused_topk as F
from genmmrec_tpu_torch.ops.topk import grouped_topk, grouped_topk_plain

CAND_MASKS = [("kernel", "mxu"), ("external", "external")]
BF16_MIN = float(jnp.finfo(jnp.bfloat16).min)


def _operands(b, n, d, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "integer":
        return rng.integers(-2, 3, (b, d)).astype(np.float32), rng.integers(-2, 3, (n, d)).astype(np.float32)
    return rng.standard_normal((b, d), np.float32), rng.standard_normal((n, d), np.float32)


def _plain_pack(dense):
    """(b, n) bool → the port's mask: little-endian bits, width a multiple of
    128 columns, the pad columns set."""
    b, n = dense.shape
    full = np.ones((b, F.n_groups_for(n) * F.GROUP), bool)
    full[:, :n] = dense
    return np.packbits(full, axis=1, bitorder="little")


def _bf16_plane(u, t):
    """numpy oracle of the score plane: bfloat16 operands, float32 sums, one
    rounding to bfloat16; returned as float32."""
    bf = lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
    return bf(bf(u) @ bf(t).T)


def _oracle_topk(plane, dense, k):
    """Stable descending sort of the masked plane: values, and indices with
    the lower index first among equal values."""
    masked = np.where(dense, -np.inf, plane)
    order = np.argsort(-masked, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(masked, order, axis=1), order


def _ordinal(x):
    """bfloat16-valued float32 array → integers in value order, one apart
    for neighbouring bfloat16 values."""
    bits = (np.asarray(x, np.float32).view(np.uint32) >> 16).astype(np.int64)
    return np.where(bits & 0x8000, -(bits & 0x7FFF), bits)


def _as_np(t):
    return t.float().numpy()


@pytest.mark.parametrize("kind", ["integer", "gaussian"])
@pytest.mark.parametrize("cand_mask,j_cand_mask", CAND_MASKS)
@pytest.mark.parametrize("n_items,k", [(TILE_N - 73, 10), (TILE_N + 500, 20)])
def test_fused_matches_jax(n_items, k, cand_mask, j_cand_mask, kind):
    b, d = 9, 64
    u, t = _operands(b, n_items, d, kind, seed=7)
    dense = np.random.default_rng(8).random((b, n_items)) < 0.05
    jv, ji = j_fused(
        jnp.asarray(u), jnp.asarray(t), k, jnp.asarray(pack_planar_mask(dense)),
        cand_mask=j_cand_mask, interpret=True,
    )
    jv, ji = np.asarray(jv, np.float32), np.asarray(ji)
    tv, ti = F.fused_grouped_topk(
        torch.from_numpy(u), torch.from_numpy(t), k, torch.from_numpy(_plain_pack(dense)), cand_mask=cand_mask
    )
    assert tv.dtype == torch.bfloat16 and ti.dtype == torch.int64 and ti.shape == (b, k)
    tv, ti = _as_np(tv), ti.numpy()
    plane = _bf16_plane(u, t)
    ov, oi = _oracle_topk(plane, dense, k)
    rows = np.arange(b)[:, None]
    assert (ti < n_items).all() and not dense[rows, ti].any()
    if kind == "integer":
        # exact sums: the JAX function's values, and the oracle's values and
        # indices everywhere; the JAX function's indices wherever a row's
        # values are distinct (it orders ties by group rank)
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tv, ov)
        np.testing.assert_array_equal(ti, oi)
        distinct = np.array([len(set(r)) == k for r in tv])
        np.testing.assert_array_equal(ti[distinct], ji[distinct])
        assert (~distinct).any(), "the integer case is there for its ties"
    else:
        # one bfloat16 ulp: the three float32 sums run in different orders
        assert np.abs(_ordinal(tv) - _ordinal(jv)).max() <= 1
        assert np.abs(_ordinal(tv) - _ordinal(ov)).max() <= 1
        for other in (ji, oi):
            diff = ti != other
            near = np.abs(_ordinal(plane[rows, ti]) - _ordinal(plane[rows, other])) <= 1
            assert near[diff].all()


@pytest.mark.parametrize("cand_mask,j_cand_mask", CAND_MASKS)
def test_fused_mask_dominated_rows(cand_mask, j_cand_mask):
    """Rows with fewer unmasked items than k: the tail is -inf where the JAX
    function shows finfo(bfloat16).min; the real entries agree and are
    unmasked; every index stays inside the catalog."""
    rng = np.random.default_rng(3)
    b, d, k, n_items = 4, 32, 12, 700
    u, t = rng.standard_normal((b, d), np.float32), rng.standard_normal((n_items, d), np.float32)
    dense = np.ones((b, n_items), bool)
    dense[np.arange(b)[:, None], rng.integers(0, n_items, (b, 5))] = False
    jv, ji = j_fused(
        jnp.asarray(u), jnp.asarray(t), k, jnp.asarray(pack_planar_mask(dense)),
        cand_mask=j_cand_mask, interpret=True,
    )
    jv, ji = np.asarray(jv, np.float32), np.asarray(ji)
    tv, ti = F.fused_grouped_topk(
        torch.from_numpy(u), torch.from_numpy(t), k, torch.from_numpy(_plain_pack(dense)), cand_mask=cand_mask
    )
    tv, ti = _as_np(tv), ti.numpy()
    n_keep = (~dense).sum(axis=1)
    assert (ti >= 0).all() and (ti < n_items).all()
    for r in range(b):
        assert (tv[r, n_keep[r]:] == -np.inf).all() and (jv[r, n_keep[r]:] == BF16_MIN).all()
        assert not dense[r, ti[r, : n_keep[r]]].any()
        np.testing.assert_array_equal(ti[r, : n_keep[r]], ji[r, : n_keep[r]])
        assert np.abs(_ordinal(tv[r, : n_keep[r]]) - _ordinal(jv[r, : n_keep[r]])).max() <= 1


def _stage_case(kind, b=6, n=700, d=32, seed=21):
    u, t = _operands(b, n, d, kind, seed)
    dense = np.random.default_rng(seed + 1).random((b, n)) < 0.3
    dense[0] = True  # a row with nothing left
    ng = F.n_groups_for(n)
    plane = np.zeros((b, ng * F.GROUP), np.float32)
    plane[:, :n] = _bf16_plane(u, t)
    full = np.ones((b, ng * F.GROUP), bool)
    full[:, :n] = dense
    return u, t, dense, plane, full, ng


@pytest.mark.parametrize("kind", ["integer", "gaussian"])
def test_group_max_plain_matches_numpy(kind):
    u, t, dense, plane, full, ng = _stage_case(kind)
    ref = np.where(full, -np.inf, plane).reshape(len(u), ng, F.GROUP).max(axis=2)
    out = F.fused_group_max(torch.from_numpy(u), torch.from_numpy(t), torch.from_numpy(_plain_pack(dense)))
    assert out.dtype == torch.bfloat16 and out.shape == (len(u), ng)
    if kind == "integer":
        np.testing.assert_array_equal(_as_np(out), ref)
    else:
        assert np.abs(_ordinal(_as_np(out)) - _ordinal(ref)).max() <= 1
    assert (_as_np(out)[0] == -np.inf).all()


@pytest.mark.parametrize("masked", [True, False])
def test_candidates_plain_match_numpy(masked):
    """Candidates of given group ids, a pad slot (n_groups) and an id below 0
    among them: the groups' scores in the order given, pad slots -inf. The
    integer operands make the comparison exact."""
    u, t, dense, plane, full, ng = _stage_case("integer")
    b = len(u)
    rng = np.random.default_rng(5)
    gidx = np.stack([rng.permutation(ng)[:4] for _ in range(b)]).astype(np.int32)
    gidx[:, 2] = ng
    gidx[1, 0] = -1
    src = np.where(full, -np.inf, plane) if masked else plane
    src = np.concatenate([src.reshape(b, ng, F.GROUP), np.full((b, 1, F.GROUP), -np.inf, np.float32)], axis=1)
    slot = np.where((gidx < 0) | (gidx >= ng), ng, gidx)
    ref = src[np.arange(b)[:, None], slot].reshape(b, -1)
    args = (torch.from_numpy(u), torch.from_numpy(t), torch.from_numpy(gidx))
    if masked:
        out = F.fused_candidates(*args, torch.from_numpy(_plain_pack(dense)))
    else:
        out = F.fused_candidates_unmasked(*args)
    assert out.dtype == torch.bfloat16 and out.shape == (b, 4 * F.GROUP)
    np.testing.assert_array_equal(_as_np(out), ref)


def test_external_mask_matches_jax():
    """``external_mask`` on the plain mask against the JAX package's
    ``_external_mask`` on the planar repacking of the same bool matrix, on
    the same candidates and group ids (one a pad slot)."""
    rng = np.random.default_rng(13)
    b, n, kp = 5, TILE_N + 300, 8
    dense = rng.random((b, n)) < 0.2
    ng_port, ng_jax = F.n_groups_for(n), 2 * TILE_N // F.GROUP
    gidx = np.stack([rng.permutation(ng_port)[:kp] for _ in range(b)]).astype(np.int32)
    cand = np.asarray(jnp.asarray(rng.standard_normal((b, kp * F.GROUP), np.float32)).astype(jnp.bfloat16))
    j_gidx = gidx.copy()
    gidx[:, -1], j_gidx[:, -1] = ng_port, ng_jax  # each package's pad slot
    ref = _external_mask(
        jnp.asarray(cand), jnp.asarray(j_gidx), jnp.asarray(pack_planar_mask(dense)), group=F.GROUP, tn=TILE_N
    )
    ref = np.asarray(ref, np.float32)
    t_cand = torch.from_numpy(cand.astype(np.float32)).bfloat16()
    out = F.external_mask(t_cand, torch.from_numpy(gidx), torch.from_numpy(_plain_pack(dense)))
    out = _as_np(out)
    np.testing.assert_array_equal(np.isinf(out), ref == BF16_MIN)
    np.testing.assert_array_equal(out[np.isfinite(out)], ref[ref != BF16_MIN])
    assert np.isinf(out[:, -F.GROUP:]).all()


@pytest.mark.parametrize(
    "b,n,d,k",
    [
        (7, 48, 16, 48),  # one group, k the whole catalog
        (7, 48, 16, 1),
        (5, 700, 32, 50),  # 6 groups < k
        (1, 700, 32, 12),  # one row
        (3, 1600, 64, 50),  # 13 groups < k
    ],
)
@pytest.mark.parametrize("cand_mask", ["kernel", "external"])
def test_fewer_groups_than_k_and_edges(b, n, d, k, cand_mask):
    """Catalogs of fewer groups than k hand all their groups on; a row fully
    masked is all -inf. Integer operands: equal to the plane's masked top-k
    (K3's plain version) bit for bit, ties included."""
    u, t = _operands(b, n, d, "integer", seed=n + k)
    dense = np.random.default_rng(n).random((b, n)) < 0.1
    dense[-1] = True
    packed = torch.from_numpy(_plain_pack(dense))
    ut, tt = torch.from_numpy(u), torch.from_numpy(t)
    v, i = F.fused_grouped_topk(ut, tt, k, packed, cand_mask=cand_mask)
    v_ref, i_ref = grouped_topk_plain(F.score_plane(ut, tt), k, packed_mask=packed)
    assert torch.equal(v, v_ref) and torch.equal(i, i_ref)
    ov, oi = _oracle_topk(_bf16_plane(u, t), dense, k)
    np.testing.assert_array_equal(_as_np(v), ov)
    np.testing.assert_array_equal(i.numpy(), oi)
    assert torch.isinf(v[-1]).all() and int(i.max()) < n


def test_fused_rejects_bad_arguments():
    u, t = torch.zeros(4, 16), torch.zeros(48, 16)
    packed = torch.from_numpy(_plain_pack(np.zeros((4, 48), bool)))
    with pytest.raises(ValueError, match="cand_mask"):
        F.fused_grouped_topk(u, t, 5, packed, cand_mask="mxu")
    wide = torch.zeros(200, 16)
    wide_packed = torch.from_numpy(_plain_pack(np.zeros((4, 200), bool)))
    for table, mask, k in ((t, packed, 0), (t, packed, 49), (wide, wide_packed, 65)):
        with pytest.raises(ValueError, match="k="):
            F.fused_grouped_topk(u, table, k, mask)


def test_kernel_route_checks_its_operands(monkeypatch):
    """Off the CPU a wrapper validates and goes to the kernel library; it
    has no other way. Meta tensors take that route without a card."""
    meta = torch.device("meta")
    bf = lambda *shape: torch.zeros(*shape, dtype=torch.bfloat16, device=meta)
    mask = torch.zeros(8, 6 * 16, dtype=torch.uint8, device=meta)
    gidx = torch.zeros(8, 5, dtype=torch.int32, device=meta)

    def library():
        raise RuntimeError("kernel library reached")

    monkeypatch.setattr(_build, "library", library)
    before = (F.fused_group_max.launches, F.fused_candidates.launches, F.fused_candidates_unmasked.launches)
    calls = {
        "group_max": lambda u, t, m=mask: F.fused_group_max(u, t, m),
        "candidates": lambda u, t, m=mask, g=gidx: F.fused_candidates(u, t, g, m),
        "unmasked": lambda u, t, m=None, g=gidx: F.fused_candidates_unmasked(u, t, g),
    }
    for name, call in calls.items():
        # a width below the kernels' is padded, so d = 40 reaches the library
        for d in (64, 40):
            with pytest.raises(RuntimeError, match="kernel library reached"):
                call(bf(8, d), bf(700, d))
        with pytest.raises(ValueError, match="bfloat16"):
            call(torch.zeros(8, 64, device=meta), bf(700, 64))
        with pytest.raises(ValueError, match="widest"):
            call(bf(8, 200), bf(700, 200))
        if name != "unmasked":
            with pytest.raises(ValueError, match="packed_mask"):
                call(bf(8, 64), bf(700, 64), m=mask[:, :-16])
            with pytest.raises(ValueError, match="packed mask"):
                call(bf(8, 64), bf(700, 64), m=None)
        if name != "group_max":
            with pytest.raises(ValueError, match="gidx"):
                call(bf(8, 64), bf(700, 64), g=gidx.long())
    after = (F.fused_group_max.launches, F.fused_candidates.launches, F.fused_candidates_unmasked.launches)
    assert after == before


def test_cpu_tensors_take_the_plain_versions():
    u, t = torch.randn(4, 16), torch.randn(300, 16)
    packed = torch.from_numpy(_plain_pack(np.zeros((4, 300), bool)))
    counters = (F.fused_group_max, F.fused_candidates, F.fused_candidates_unmasked, grouped_topk)
    before = [c.launches for c in counters]
    for cand_mask in ("kernel", "external"):
        F.fused_grouped_topk(u, t, 5, packed, cand_mask=cand_mask)
    assert [c.launches for c in counters] == before


@pytest.mark.parametrize("k,masked", [(50, True), (1, False), (7, True)])
def test_grouped_topk_on_bf16_rows_matches_lax_top_k(k, masked):
    """K3's plain version on a bfloat16 plane against lax.top_k on the same
    plane: bfloat16 values out, the lower index first among the many ties."""
    rng = np.random.default_rng(k)
    b, n = 16, 3000
    plane = jnp.asarray(rng.standard_normal((b, n), np.float32)).astype(jnp.bfloat16)
    dense = rng.random((b, n)) < 0.1 if masked else np.zeros((b, n), bool)
    jv, ji = jax.lax.top_k(jnp.where(jnp.asarray(dense), -jnp.inf, plane), k)
    s = torch.from_numpy(np.array(plane.astype(jnp.float32))).bfloat16()
    packed = torch.from_numpy(np.packbits(dense, axis=1, bitorder="little")) if masked else None
    tv, ti = grouped_topk(s, k, packed_mask=packed)
    assert tv.dtype == torch.bfloat16
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(_as_np(tv), np.asarray(jv, np.float32))
    assert len(np.unique(_as_np(tv)[0])) < k or k == 1


def test_grouped_topk_refuses_other_types_off_the_cpu():
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            grouped_topk(torch.zeros(4, 300, dtype=dtype, device="meta"), 5)
