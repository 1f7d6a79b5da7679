"""K5a's H100 design in Python (``genmmrec_tpu_torch/ops/fused_topk.py``
``fold_work_plan``, ``fold_mask_word``, ``fused_group_max_tiled_plain``)
against the port's plain version and the JAX package's ``_fold_kernel``
(Pallas in interpret mode, called as ``fused_grouped_topk`` calls it, with
``pack_planar_mask``), on the CPU.

- The persistent grid: every (row, group) belongs to exactly one unit, on
  the SM counts of an H100 SXM (132) and PCIe (114) card (the kernel reads
  the count from the device), at the row counts the paths give the kernel
  (1, 63, 64, DiffMM/baby's and LightGCN/elec's last chunks' 3,061 and
  3,708, the 4,096 of a full chunk) and catalogs of one group to the elec
  width.
- The epilogue: the 32-bit mask word of each thread, the float32 maximum of
  its included sums, one rounding. Integer-valued operands (every sum exact
  in bfloat16 in any order): bit-equal to both references. Gaussian
  operands: equal to the port's plain version, whose float32 sums are the
  same matmul's, and within one bfloat16 ulp of the JAX kernel's (XLA sums
  in another order). Excluded items, fully masked rows and groups: ``-inf``
  here, ``finfo(bfloat16).min`` in the JAX kernel (the known contract).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from genmmrec_tpu.ops.fused_topk import _BT, TILE_N, _fold_kernel, n_full_for, pack_planar_mask
from genmmrec_tpu_torch.ops import fused_topk as F

BF16_MIN = float(jnp.finfo(jnp.bfloat16).min)
ELEC_ITEMS = 63001


@pytest.mark.parametrize("sms", [132, 114], ids=["sxm", "pcie"])
@pytest.mark.parametrize("n", [1, 127, 128, 7050, ELEC_ITEMS])
@pytest.mark.parametrize("b", [1, 63, 64, 3061, 3708, 4096])
def test_work_units_cover_every_row_and_group_once(b, n, sms):
    ng = F.n_groups_for(n)
    grid, units = F.fold_work_plan(b, ng, sms)
    assert 1 <= grid <= sms and grid == min(len(units), sms)
    covered = np.zeros((b, ng), np.int32)
    for r0, r1, g0, g1 in units:
        assert 0 <= r0 < r1 <= b and 0 <= g0 < g1 <= ng
        # the unit's rows are the ones a block keeps in shared memory
        assert r0 % F.FOLD_UNIT_ROWS == 0 and r1 - r0 <= F.FOLD_UNIT_ROWS
        covered[r0:r1, g0:g1] += 1
    assert (covered == 1).all()
    # the grid's blocks share the units out, each unit to one block
    taken = sorted(u for x in range(grid) for u in range(x, len(units), grid))
    assert taken == list(range(len(units)))
    if b == 4096 and n == ELEC_ITEMS and sms == 132:
        assert (grid, len(units)) == (128, 128)  # one unit a block: 8 row chunks x 16 chunks of 31 groups


@pytest.mark.parametrize("seed", range(4))
def test_mask_word_maps_each_bit_to_its_column(seed):
    rng = np.random.default_rng(seed)
    group = rng.integers(0, 256, (64, 16), dtype=np.uint8)
    bits = np.unpackbits(group, axis=1, bitorder="little")  # (64, 128): bit of item i
    for t in range(4):
        word = F.fold_mask_word(torch.from_numpy(group), t).numpy()
        assert (word >= 0).all() and (word < 2**32).all()
        for j in range(16):
            for c in range(2):
                got = (word >> F.fold_mask_bit(j, c)) & 1
                np.testing.assert_array_equal(got, bits[:, 8 * j + 2 * t + c])


def _operands(b, n, d, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "integer":
        return rng.integers(-2, 3, (b, d)).astype(np.float32), rng.integers(-2, 3, (n, d)).astype(np.float32)
    return rng.standard_normal((b, d), np.float32), rng.standard_normal((n, d), np.float32)


def _dense_mask(b, n, seed):
    """Random train positives, a row with every item excluded, a row with
    all but two, and a group (the third) with every item excluded."""
    rng = np.random.default_rng(seed)
    dense = rng.random((b, n)) < 0.03
    dense[0] = True
    dense[1, 2:] = True
    dense[:, 256:384] = True
    return dense


def _plain_pack(dense):
    b, n = dense.shape
    full = np.ones((b, F.n_groups_for(n) * F.GROUP), bool)
    full[:, :n] = dense
    return np.packbits(full, axis=1, bitorder="little")


def _ordinal(x):
    bits = (np.asarray(x, np.float32).view(np.uint32) >> 16).astype(np.int64)
    return np.where(bits & 0x8000, -(bits & 0x7FFF), bits)


def _jax_fold(u, t, dense):
    """The JAX package's fold kernel in interpret mode, as
    ``fused_grouped_topk`` calls it: the table padded to the planar tile,
    the rows to the user tile (their mask set), the planar mask."""
    b, d = u.shape
    n = t.shape[0]
    nf = n_full_for(n)
    b_pad = -(-b // _BT) * _BT
    planar = np.pad(pack_planar_mask(dense), ((0, b_pad - b), (0, 0)), constant_values=255)
    ue = jnp.pad(jnp.asarray(u).astype(jnp.bfloat16), ((0, b_pad - b), (0, 0)))
    table = jnp.pad(jnp.asarray(t), ((0, nf - n), (0, 0))).astype(jnp.bfloat16).T
    gmax = pl.pallas_call(
        partial(_fold_kernel, bt=_BT, tn=TILE_N, nt=nf // TILE_N, group=F.GROUP),
        grid=(b_pad // _BT,),
        in_specs=[
            pl.BlockSpec((_BT, d), lambda i: (i, 0)),
            pl.BlockSpec((d, nf), lambda i: (0, 0)),
            pl.BlockSpec((_BT, nf // 8), lambda i: (i, 0)),
        ],
        out_specs=pl.BlockSpec((_BT, nf // F.GROUP), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((b_pad, nf // F.GROUP), jnp.bfloat16),
        interpret=True,
    )(ue, table, jnp.asarray(planar))
    return np.asarray(gmax.astype(jnp.float32))[:b, : F.n_groups_for(n)]


def _tiled(u, t, dense, sms=F.H100_SMS):
    tu, tt = torch.from_numpy(u).bfloat16(), torch.from_numpy(t).bfloat16()
    mask = torch.from_numpy(_plain_pack(dense))
    return F.fused_group_max_tiled_plain(tu, tt, mask, sms=sms), (tu, tt, mask)


@pytest.mark.parametrize("sms", [132, 114], ids=["sxm", "pcie"])
@pytest.mark.parametrize("d", [32, 40, 64, 128])
@pytest.mark.parametrize("kind", ["integer", "gaussian"])
def test_tiled_mirror_equals_plain(kind, d, sms):
    b, n = 1000, 1000  # not a multiple of the units' rows; a last group of 104 items
    u, t = _operands(b, n, d, kind, seed=d)
    got, (tu, tt, mask) = _tiled(u, t, _dense_mask(b, n, seed=d), sms)
    ref = F.fused_group_max_plain(tu, tt, mask)
    if kind == "integer" or d in F.KERNEL_WIDTHS:
        # the same float32 sums (d = 40 is padded to 64 here, a matmul of
        # another depth in plain), one rounding either way
        assert torch.equal(got, ref)
    else:
        apart = np.abs(_ordinal(got.float().numpy()) - _ordinal(ref.float().numpy()))
        assert apart.max() <= 1
    assert torch.isinf(got[0]).all() and torch.isinf(got[:, 2]).all()  # a masked row, a masked group


@pytest.mark.parametrize("d", [32, 40, 64, 128])
@pytest.mark.parametrize("kind", ["integer", "gaussian"])
def test_tiled_mirror_against_jax_fold_kernel(kind, d):
    b, n = 70, 1000
    u, t = _operands(b, n, d, kind, seed=100 + d)
    dense = _dense_mask(b, n, seed=100 + d)
    got = _tiled(u, t, dense)[0].float().numpy()
    ref = _jax_fold(u, t, dense)
    excluded = np.isneginf(got)
    np.testing.assert_array_equal(excluded, ref == BF16_MIN)
    if kind == "integer":
        np.testing.assert_array_equal(got[~excluded], ref[~excluded])
    else:
        assert np.abs(_ordinal(got[~excluded]) - _ordinal(ref[~excluded])).max() <= 1


def test_tiled_mirror_at_the_elec_tail():
    """The elec catalog's last group holds 25 items (63,001 = 492·128 + 25):
    the other 103 columns are excluded by the mask's set pad bits, never by
    their zero scores. Every score here is negative, so a pad column that
    scored its zero would win its group."""
    b, d = 8, 32
    rng = np.random.default_rng(7)
    u = np.abs(rng.integers(1, 3, (b, d))).astype(np.float32)
    t = -np.abs(rng.integers(1, 3, (ELEC_ITEMS, d))).astype(np.float32)
    dense = np.zeros((b, ELEC_ITEMS), bool)
    got, (tu, tt, mask) = _tiled(u, t, dense)
    assert torch.equal(got, F.fused_group_max_plain(tu, tt, mask))
    assert got.shape == (b, 493) and bool((got[:, -1].float() < 0).all())


def test_tiled_mirror_refuses_a_cuda_tensor():
    """The mirror is the kernel's arithmetic for the CPU; the wrapper, not
    the mirror, serves a tensor on the card."""

    class OnCard:
        is_cpu = False

    with pytest.raises(ValueError):
        F.fused_group_max_tiled_plain(OnCard(), None, None)
