"""The port's raw-feature utilities (``genmmrec_tpu_torch/data/data_utils.py``)
against ``genmmrec_tpu/data/data_utils.py`` on the CPU: the grouping
helpers, the MLM masking bit-equal with the JAX key's draws handed in (and
the statistics of the port's own draws), the image pipeline (``ImageResize``
within 1e-3 of ``jax.image.resize`` when it shrinks and when it enlarges),
the LMDB decode of a PNG."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genmmrec_tpu.data import data_utils as J
from genmmrec_tpu_torch.data import data_utils as T


@pytest.mark.parametrize("n, size, pad", [(3, 2, True), (3, 2, False), (7, 3, True), (7, 3, False), (4, 4, True)])
def test_grouping_helpers(n, size, pad):
    ex = [{"id": k, "v": k * k} for k in range(n)]
    assert T.chunk_list(ex, size, pad) == J.chunk_list(ex, size, pad)
    assert T.flat_list_of_lists([[1, 2], [], [3]]) == J.flat_list_of_lists([[1, 2], [], [3]])
    groups = {"a": ex, "b": ex[:1]}
    for train in (True, False):
        assert T.mk_input_group(groups, size, train, "id") == J.mk_input_group(groups, size, train, "id")


def test_repeat_tensor_rows():
    x = np.arange(12).reshape(4, 3)
    for reps in ([1, 2, 0, 3], [1, 1, 1, 1]):
        got = T.repeat_tensor_rows(torch.from_numpy(x), reps)
        np.testing.assert_array_equal(got.numpy(), np.asarray(J.repeat_tensor_rows(jnp.asarray(x), reps)))


def _jax_draws(key, shape, vocab):
    """The draws of the JAX ``mask_batch_text_tokens`` for ``key``, rebuilt."""
    k_sel, k_mask, k_rand, k_tok = jax.random.split(key, 4)
    prob = jnp.full(shape, 0.15)
    host = lambda a: torch.from_numpy(np.array(a))
    return dict(
        select_u=host(jax.random.uniform(k_sel, shape, prob.dtype)),
        replace=host(jax.random.bernoulli(k_mask, 0.8, shape)),
        random=host(jax.random.bernoulli(k_rand, 0.5, shape)),
        tokens=host(jax.random.randint(k_tok, shape, 0, vocab)),
    )


@pytest.mark.parametrize("special", [False, True])
def test_mlm_transform_bit_equal_with_jax_draws(special):
    rng = np.random.default_rng(3)
    inputs = rng.integers(1000, 2000, (48, 40)).astype(np.int32)
    smask = np.zeros_like(inputs)
    smask[:, 0] = smask[:, -1] = 1
    key = jax.random.PRNGKey(17)
    j_out, j_lab = J.mask_batch_text_tokens(
        key, jnp.asarray(inputs), 103, 500, special_tokens_mask=jnp.asarray(smask) if special else None
    )
    t_out, t_lab = T.mask_text_tokens(
        torch.from_numpy(inputs), _jax_draws(key, inputs.shape, 500), 103,
        special_tokens_mask=torch.from_numpy(smask) if special else None,
    )
    np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
    np.testing.assert_array_equal(t_lab.numpy(), np.asarray(j_lab))
    assert t_out.dtype == torch.int32 and (t_lab.numpy() != -100).any()


def test_mlm_own_draws_statistics():
    """15% selected, of those 80% [MASK], 10% random, 10% kept (each within
    4 sigma); labels -100 exactly off the selection; special tokens never
    selected; the same generator seed gives the same masking."""
    b, s, mask_id, vocab = 256, 128, 103, 30000
    inputs = torch.full((b, s), 7, dtype=torch.int64)
    special = torch.zeros_like(inputs)
    special[:, 0] = 1
    out, lab = T.mask_batch_text_tokens(inputs, mask_id, vocab, torch.Generator().manual_seed(0), special)
    sel = lab != -100
    n = b * (s - 1)
    p = sel.sum().item() / n
    assert abs(p - 0.15) < 4 * (0.15 * 0.85 / n) ** 0.5
    assert not sel[:, 0].any() and torch.equal(lab[sel], inputs[sel]) and torch.equal(out[~sel], inputs[~sel])
    m = sel.sum().item()
    masked = (out[sel] == mask_id).float().mean().item()
    changed = ((out[sel] != mask_id) & (out[sel] != 7)).float().mean().item()
    assert abs(masked - 0.8) < 4 * (0.8 * 0.2 / m) ** 0.5
    assert abs(changed - 0.1) < 4 * (0.1 * 0.9 / m) ** 0.5 + 1.0 / vocab
    again = T.mask_batch_text_tokens(inputs, mask_id, vocab, torch.Generator().manual_seed(0), special)
    assert torch.equal(again[0], out) and torch.equal(again[1], lab)


def test_image_to_tensor_padding_and_sizes():
    rng = np.random.default_rng(0)
    for shape in ((9, 7), (9, 7, 3), (2, 9, 7, 3)):
        img = rng.integers(0, 256, shape).astype(np.uint8)
        np.testing.assert_array_equal(T.image_to_tensor(img).numpy(), np.asarray(J.image_to_tensor(img)))
    img = rng.integers(0, 256, (3, 9, 7)).astype(np.uint8)
    np.testing.assert_array_equal(T.image_to_tensor(img, keepdim=False).numpy(), np.asarray(J.image_to_tensor(img, keepdim=False)))
    with pytest.raises(ValueError):
        T.image_to_tensor(np.zeros(3))
    for pad_all in (False, True):
        for mw, mh in ((12, 16), (11, 10), (7, 9)):
            assert T.get_padding(img, mw, mh, pad_all) == J.get_padding(img, mw, mh, pad_all)
            assert T.get_padding(torch.from_numpy(img), mw, mh, pad_all) == J.get_padding(img, mw, mh, pad_all)
    for mode in ("constant", "edge", "reflect", "symmetric"):
        pad_t, pad_j = T.ImagePad(12, 15, fill=3, padding_mode=mode), J.ImagePad(12, 15, fill=3, padding_mode=mode)
        np.testing.assert_array_equal(pad_t(img), pad_j(img))
        np.testing.assert_array_equal(pad_t(torch.from_numpy(img)).numpy(), pad_j(img))
    assert repr(T.ImagePad(12, 15)) == repr(J.ImagePad(12, 15))
    for shape in ((3, 40, 30), (3, 30, 40), (3, 25, 25)):
        for ms in (7, 50, 1000):
            assert T.get_resize_size(np.zeros(shape), ms) == J.get_resize_size(np.zeros(shape), ms)


@pytest.mark.parametrize(
    "shape, max_size",
    [((40, 30, 3), 20), ((40, 30, 3), 90), ((3, 37, 53), 16), ((3, 37, 53), 100), ((25, 25), 7), ((64, 48, 4), 64)],
)
def test_image_resize_against_jax(shape, max_size):
    """Shrinking and enlarging, numpy in and numpy out, and a tensor batch."""
    img = np.random.default_rng(sum(shape) + max_size).integers(0, 256, shape).astype(np.uint8)
    ref = J.ImageResize(max_size)(img)
    got = T.ImageResize(max_size)(img)
    assert isinstance(got, np.ndarray) and got.shape == ref.shape and got.dtype == np.float32
    assert np.abs(got - ref).max() <= 1e-3
    # the CxHxW array that both resize
    chw = img[None] if img.ndim == 2 else img.transpose(2, 0, 1) if img.shape[-1] in (1, 3, 4) else img
    chw = torch.from_numpy(np.ascontiguousarray(chw))
    batch = T.ImageResize(max_size)(torch.stack([chw, chw.flip(-1)]))
    assert torch.is_tensor(batch) and batch.shape == (2, *ref.shape)
    assert np.abs(batch[0].numpy() - ref).max() <= 1e-3
    assert repr(T.ImageResize(max_size)) == repr(J.ImageResize(max_size))


def test_image_norm_and_imagenet_transform():
    img = np.random.default_rng(5).integers(0, 256, (30, 20, 3)).astype(np.uint8)
    norm_t = T.ImageNorm([0.485, 0.456, 0.406], [0.229, 0.224, 0.225])
    norm_j = J.ImageNorm([0.485, 0.456, 0.406], [0.229, 0.224, 0.225])
    chw = img.transpose(2, 0, 1).astype(np.float32)
    np.testing.assert_array_equal(norm_t(chw), norm_j(chw))
    np.testing.assert_allclose(norm_t(torch.from_numpy(chw)).numpy(), norm_j(chw), rtol=1e-6, atol=1e-6)
    got = T.get_imagenet_transform(max_size=48)(img)
    ref = J.get_imagenet_transform(max_size=48)(img)
    assert got.shape == ref.shape and np.abs(got - ref).max() <= 1e-3 / 0.224
    with pytest.warns(UserWarning):
        T.get_imagenet_transform(min_size=500, max_size=48)


def test_lmdb_value_decode():
    from PIL import Image

    for mode, shape in (("RGB", (16, 12, 3)), ("L", (9, 11))):
        arr = np.random.default_rng(1).integers(0, 255, shape, np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr, mode=mode).save(buf, format="PNG")
        got = T.load_decompress_img_from_lmdb_value(buf.getvalue())
        np.testing.assert_array_equal(got, J.load_decompress_img_from_lmdb_value(buf.getvalue()))
        assert got.shape == shape[:2] + (3,)
