"""K4's plain version and the switched two-stage route of the port's
``grouped_topk`` against the JAX package, on the CPU.

``candidate_extract_plain`` is held against the Pallas kernel
``_candidate_extract_pallas`` in interpret mode on the same masked plane and
the same groups, and the route that ``GENMMREC_PALLAS_TOPK`` switches on
against ``lax.top_k`` of the masked row. Float32 draws are continuous, so
indices must be equal; bfloat16 rows hold real ties, where the port orders by
index as ``lax.top_k`` does (the JAX two-stage orders by group rank, so it
is compared by values there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genmmrec_tpu.ops.topk import _candidate_extract_pallas
from genmmrec_tpu_torch.ops import topk as T

GROUP = 128
_t = torch.from_numpy


def _case(b, n, per_row, seed):
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((b, n)).astype(np.float32)
    dense = np.zeros((b, n), bool)
    for r in range(b):
        dense[r, rng.choice(n, size=per_row, replace=False)] = True
    return s, dense, np.packbits(dense, axis=1, bitorder="little")


def _jax_plane(s, dense, dtype):
    """The finite-sentinel masked plane (b, g, 128) the JAX route hands its kernel."""
    b, n = s.shape
    ng = -(-n // GROUP)
    neg_fin = float(jnp.finfo(dtype).min)
    plane = np.full((b, ng * GROUP), neg_fin, np.float32)
    plane[:, :n] = np.where(dense, neg_fin, s)
    return jnp.asarray(plane).astype(dtype).reshape(b, ng, GROUP)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_candidate_extract_plain_matches_the_pallas_kernel(dtype, masked):
    """``tests/test_topk.py``'s case with a ragged last group (63,001 =
    492·128 + 25 columns) and 30 positives a row: same groups in, same
    indices and values out."""
    b, n, k = 16, 63001, 50
    s, dense, packed = _case(b, n, 30, seed=7)
    if not masked:
        dense = np.zeros_like(dense)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    ts = _t(s).to(tdt)
    s_in = ts.float().numpy()  # the scores both sides see, exactly
    sm3 = _jax_plane(s_in, dense, jdt)
    mask = _t(packed) if masked else None
    gidx = T.choose_groups(T.masked_group_max(ts, mask), k)
    v_ref, i_ref = _candidate_extract_pallas(sm3, jnp.asarray(gidx.numpy()), k, GROUP, interpret=True)
    v, i = T.candidate_extract_plain(ts, gidx, k, mask)
    assert i.dtype == torch.int64 and v.dtype == tdt and i.shape == (b, k)
    np.testing.assert_array_equal(v.float().numpy(), np.asarray(v_ref, np.float32))
    # bfloat16 rows hold ties: the Pallas kernel takes the first occurrence
    # among the groups as handed on, sorted by id here, so the lists are equal
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    # the wrapper on CPU tensors is the plain version, and counts no launch
    before = T.candidate_extract.launches
    v2, i2 = T.candidate_extract(ts, gidx, k, mask)
    assert torch.equal(i2, i) and torch.equal(v2, v) and T.candidate_extract.launches == before


@pytest.mark.parametrize(
    "b,n,k,dtype,masked",
    [
        (32, 63001, 50, "float32", True),  # the evaluation's shape: 493 groups, a last group of 25
        (32, 63001, 50, "float32", False),
        (32, 63001, 50, "bfloat16", True),
        (16, 13000, 1, "float32", False),  # the regeneration's top-1
        (16, 13000, 7, "bfloat16", False),
        (8, 12800, 50, "float32", True),  # 100 groups = 2k: the narrow-row rule keeps K3
        (8, 1600, 50, "float32", True),  # 13 groups
    ],
)
def test_switched_grouped_topk_matches_lax_top_k(monkeypatch, b, n, k, dtype, masked):
    s, dense, packed = _case(b, n, 200 if n > 2000 else 50, seed=n + k)
    tdt, jdt = (torch.float32, jnp.float32) if dtype == "float32" else (torch.bfloat16, jnp.bfloat16)
    ts = _t(s).to(tdt)
    mask = _t(packed) if masked else None
    ref_scores = jnp.asarray(ts.float().numpy()).astype(jdt)
    if masked:
        ref_scores = jnp.where(jnp.asarray(dense), -jnp.inf, ref_scores)
    v_ref, i_ref = jax.lax.top_k(ref_scores, k)
    off_v, off_i = T.grouped_topk(ts, k, mask)

    calls = []
    real = T.candidate_extract
    monkeypatch.setattr(T, "candidate_extract", lambda *a: calls.append(1) or real(*a))
    monkeypatch.setenv("GENMMREC_PALLAS_TOPK", "1")
    v, i = T.grouped_topk(ts, k, mask)
    assert len(calls) == (1 if -(-n // GROUP) > 2 * k else 0)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_array_equal(v.float().numpy(), np.asarray(v_ref, np.float32))
    assert torch.equal(i, off_i) and torch.equal(v, off_v)


def test_pad_slots_ragged_tail_and_short_rows():
    """Pad slots (a group id of n_groups, or below 0) and the columns past
    the catalog never win; masked entries take part at -inf, lower index
    first; a row that runs out of real candidates ends in (-inf, -1)."""
    n, k = 300, 6  # 3 groups, the last of 44
    s = np.zeros((3, n), np.float32)
    s[0, [5, 130, 299]] = [3.0, 9.0, 1.0]
    s[1, :] = -1.0
    s[1, [256, 257, 258]] = [2.0, 2.0, 2.0]
    s[2, :] = np.arange(n, dtype=np.float32)
    dense = np.zeros((3, n), bool)
    dense[0, 130] = True
    dense[2, 260:] = True
    packed = _t(np.packbits(dense, axis=1, bitorder="little"))
    gidx = torch.tensor([[0, 1, 3], [2, -1, 3], [2, 3, 3]], dtype=torch.int32)
    v, i = T.candidate_extract(_t(s), gidx, k, packed)
    assert i[0].tolist() == [5, 0, 1, 2, 3, 4] and v[0].tolist() == [3.0, 0.0, 0.0, 0.0, 0.0, 0.0]
    assert i[1].tolist() == [256, 257, 258, 259, 260, 261] and v[1].tolist() == [2.0, 2.0, 2.0, -1.0, -1.0, -1.0]
    # four live items, then the masked ones at -inf in index order
    assert i[2].tolist() == [259, 258, 257, 256, 260, 261]
    assert v[2].tolist() == [259.0, 258.0, 257.0, 256.0, float("-inf"), float("-inf")]
    # the last group alone has 44 real columns: k = 50 runs out
    v, i = T.candidate_extract(_t(s[2:]), torch.tensor([[2]], dtype=torch.int32), 50, packed[2:])
    assert i[0, :4].tolist() == [259, 258, 257, 256] and i[0, 4:44].tolist() == list(range(260, 300))
    assert i[0, 44:].tolist() == [-1] * 6 and bool(torch.isinf(v[0, 4:]).all())
    with pytest.raises(ValueError, match="int32"):
        T.candidate_extract(_t(s), gidx.long(), k, packed)
    with pytest.raises(ValueError, match="k="):
        T.candidate_extract(_t(s), gidx, 65, packed)


def test_bf16_ties_come_lower_index_first():
    """bfloat16 keeps 8 bits of mantissa: 20,000 columns hold many equal
    values. With the groups ranked by (maximum, then id) and handed on sorted
    by id, the two-stage route gives ``lax.top_k``'s list exactly."""
    rng = np.random.default_rng(4)
    s = _t(rng.standard_normal((8, 20000)).astype(np.float32)).bfloat16()
    v_ref, i_ref = jax.lax.top_k(jnp.asarray(s.float().numpy()).astype(jnp.bfloat16), 20)
    gidx = T.choose_groups(T.masked_group_max(s), 20)
    assert bool((gidx[:, 1:] > gidx[:, :-1]).all())
    v, i = T.candidate_extract(s, gidx, 20)
    assert len(np.unique(np.asarray(v_ref, np.float32)[0])) < 20  # ties are there
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_array_equal(v.float().numpy(), np.asarray(v_ref, np.float32))
