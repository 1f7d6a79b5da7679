"""Raw-feature utilities (dormant path: ``end2end`` is False by default).

Counterpart of ``genmmrec_tpu/data/data_utils.py`` in torch, for the
reference's ``src/utils/data_utils.py:22-380``:

- ``flat_list_of_lists`` / ``chunk_list`` / ``mk_input_group`` /
  ``repeat_tensor_rows``: grouping helpers;
- ``mask_batch_text_tokens``: BERT-style MLM masking, split into its draws
  from an explicit ``torch.Generator`` (``mlm_draws``) and a pure
  transform of them (``mask_text_tokens``), so that other draws can be
  handed in;
- ``image_to_tensor`` / ``get_padding`` / ``ImagePad`` / ``get_resize_size``
  / ``ImageResize`` / ``ImageNorm`` / ``get_imagenet_transform``: the image
  pipeline. ``ImageResize`` is ``F.interpolate`` with ``antialias=True``
  and ``align_corners=False``, which agrees with ``jax.image.resize``
  when it shrinks an image as well as when it enlarges one;
- ``load_decompress_img_from_lmdb_value``: PIL, imported inside it.

A transform given a numpy array (or a PIL image) returns numpy, as the JAX
package's do; given a tensor it returns a tensor on the tensor's device.
"""

from __future__ import annotations

import warnings
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


# ----------------------------------------------------------------------
def flat_list_of_lists(l):
    """[[1,2], [3]] -> [1,2,3] (data_utils.py:22-24)."""
    return [item for sublist in l for item in sublist]


def chunk_list(examples, chunk_size=2, pad_to_divisible=True):
    """Split into fixed-size chunks, optionally padding the tail by cycling
    earlier examples (data_utils.py:283-308)."""
    n_examples = len(examples)
    remainder = n_examples % chunk_size
    if pad_to_divisible and remainder > 0:
        n_pad = chunk_size - remainder
        examples = list(examples) + list(examples[:n_pad])
        n_examples = len(examples)
        remainder = 0
    chunked = [examples[i : i + chunk_size] for i in range(0, n_examples, chunk_size)]
    if not pad_to_divisible and remainder > 0:
        chunked = chunked[:-1] + [examples[-remainder:]]
    return chunked


def mk_input_group(key_grouped_examples: dict, max_n_example_per_group=2, is_train=True,
                   example_unique_key: Optional[str] = None):
    """(key, examples-chunk) pairs per key (data_utils.py:311-345); groups
    of one at evaluation."""
    input_groups = []
    for k, examples in key_grouped_examples.items():
        chunk_size = max_n_example_per_group if is_train else 1
        for c in chunk_list(examples, chunk_size=chunk_size, pad_to_divisible=is_train):
            input_groups.append((k, c))
    if example_unique_key is not None:
        flat = flat_list_of_lists([c for _, c in input_groups])
        n_in = len(flat_list_of_lists(list(key_grouped_examples.values())))
        n_out = len({e[example_unique_key] for e in flat})
        assert n_out <= n_in
    return input_groups


def repeat_tensor_rows(raw_tensor: torch.Tensor, row_repeats: Sequence[int]) -> torch.Tensor:
    """Repeat each row k times (data_utils.py:348-364)."""
    assert len(row_repeats) == raw_tensor.shape[0]
    if all(r == 1 for r in row_repeats):
        return raw_tensor
    return torch.repeat_interleave(raw_tensor, torch.as_tensor(row_repeats, device=raw_tensor.device), dim=0)


# ----------------------------------------------------------------------
def mlm_draws(shape, vocab_size: int, generator: torch.Generator, device=None) -> dict:
    """The draws of one MLM masking: ``select_u`` uniforms in [0, 1) (a
    token is selected where it is below the probability), ``replace`` (80%:
    the token becomes [MASK]), ``random`` (50% of the rest: a random token)
    and the random ``tokens`` in [0, vocab_size)."""
    device = device if device is not None else generator.device
    rand = lambda: torch.rand(shape, generator=generator, device=device)
    return dict(
        select_u=rand(),
        replace=rand() < 0.8,
        random=rand() < 0.5,
        tokens=torch.randint(0, vocab_size, shape, generator=generator, device=device),
    )


def mask_text_tokens(inputs: torch.Tensor, draws: dict, mask_token_id: int,
                     special_tokens_mask: Optional[torch.Tensor] = None, mlm_probability: float = 0.15):
    """The masking as a pure function of its draws: (inputs with the
    selected tokens replaced, labels: the input where selected, -100
    elsewhere). Special tokens are never selected."""
    selected = draws["select_u"] < mlm_probability
    if special_tokens_mask is not None:
        selected = selected & ~special_tokens_mask.bool()
    labels = torch.where(selected, inputs, torch.full_like(inputs, -100))
    replace = draws["replace"] & selected
    out = torch.where(replace, torch.full_like(inputs, mask_token_id), inputs)
    random = draws["random"] & selected & ~replace
    out = torch.where(random, draws["tokens"].to(inputs.dtype), out)
    return out, labels


def mask_batch_text_tokens(inputs: torch.Tensor, mask_token_id: int, vocab_size: int,
                           generator: torch.Generator, special_tokens_mask: Optional[torch.Tensor] = None,
                           mlm_probability: float = 0.15):
    """BERT MLM masking (data_utils.py:27-76): 15% of the tokens become
    prediction targets; of those 80% -> [MASK], 10% -> a random token, 10%
    unchanged. Labels are -100 off the targets."""
    draws = mlm_draws(inputs.shape, vocab_size, generator, inputs.device)
    return mask_text_tokens(inputs, draws, mask_token_id, special_tokens_mask, mlm_probability)


# ----------------------------------------------------------------------
def image_to_tensor(image: np.ndarray, keepdim: bool = True) -> torch.Tensor:
    """HxW / HxWxC / BxHxWxC numpy -> CxHxW-style tensor (data_utils.py:77-113)."""
    image = np.asarray(image)
    if image.ndim == 2:
        tensor = image[None]
    elif image.ndim == 3:
        tensor = image.transpose(2, 0, 1)
        if not keepdim:
            tensor = tensor[None]
    elif image.ndim == 4:
        tensor = image.transpose(0, 3, 1, 2)
    else:
        raise ValueError(f"Cannot process image with shape {image.shape}")
    return torch.from_numpy(np.ascontiguousarray(tensor))


def _height_width(image):
    if isinstance(image, (np.ndarray, torch.Tensor)):
        return tuple(image.shape[-2:])
    w, h = image.size  # PIL
    return h, w


def get_padding(image, max_w: int, max_h: int, pad_all: bool = False):
    """(left, top, right, bottom) padding to max_w x max_h (data_utils.py:116-137)."""
    h, w = _height_width(image)
    h_padding, v_padding = max_w - w, max_h - h
    if pad_all:
        h_padding /= 2
        v_padding /= 2
        l_pad = h_padding if h_padding % 1 == 0 else h_padding + 0.5
        t_pad = v_padding if v_padding % 1 == 0 else v_padding + 0.5
        r_pad = h_padding if h_padding % 1 == 0 else h_padding - 0.5
        b_pad = v_padding if v_padding % 1 == 0 else v_padding - 0.5
    else:
        l_pad, t_pad = 0, 0
        r_pad, b_pad = h_padding, v_padding
    return int(l_pad), int(t_pad), int(r_pad), int(b_pad)


class ImagePad:
    """Pad to max_w x max_h at the right and bottom (data_utils.py:140-168)."""

    def __init__(self, max_w, max_h, fill=0, padding_mode="constant"):
        assert padding_mode in ["constant", "edge", "reflect", "symmetric"]
        self.max_w, self.max_h = max_w, max_h
        self.fill = fill
        self.padding_mode = padding_mode

    def __call__(self, img):
        is_tensor = isinstance(img, torch.Tensor)
        arr = img.cpu().numpy() if is_tensor else np.asarray(img)
        left, top, right, bottom = get_padding(arr, self.max_w, self.max_h)
        pad_width = [(0, 0)] * (arr.ndim - 2) + [(top, bottom), (left, right)]
        kwargs = {"constant_values": self.fill} if self.padding_mode == "constant" else {}
        out = np.pad(arr, pad_width, mode=self.padding_mode, **kwargs)
        return torch.from_numpy(out).to(img.device) if is_tensor else out

    def __repr__(self):
        return (
            f"{self.__class__.__name__}(max_w={self.max_w}, max_h={self.max_h}, "
            f"fill={self.fill}, padding_mode={self.padding_mode})"
        )


def get_resize_size(image, max_size: int):
    """(new_h, new_w) with the longer side scaled to max_size (data_utils.py:171-203)."""
    height, width = _height_width(image)
    if height >= width:
        ratio = width / height
        new_height = max_size
        new_width = new_height * ratio
    else:
        ratio = height / width
        new_width = max_size
        new_height = new_width * ratio
    return int(new_height), int(new_width)


_MODES = {"bilinear": "bilinear", "linear": "bilinear", "bicubic": "bicubic", "cubic": "bicubic"}


class ImageResize:
    """Resize so that the longer side is max_size (data_utils.py:206-243):
    ``F.interpolate`` with antialiasing, ``align_corners=False``. Takes a
    numpy HxW, HxWxC (C of 1, 3 or 4) or CxHxW array or PIL image, or a
    (..., H, W) tensor, a batch included."""

    def __init__(self, max_size: int, interpolation: str = "bilinear"):
        assert isinstance(max_size, int)
        if interpolation not in _MODES:
            raise ValueError(f"interpolation {interpolation!r} is not one of {sorted(_MODES)}")
        self.max_size = max_size
        self.interpolation = interpolation

    def __call__(self, img):
        is_tensor = isinstance(img, torch.Tensor)
        if is_tensor:
            x = img.float()
        else:
            arr = np.asarray(img, np.float32)
            if arr.ndim == 2:
                arr = arr[None]
            elif arr.ndim == 3 and arr.shape[-1] in (1, 3, 4):
                arr = arr.transpose(2, 0, 1)  # PIL HxWxC -> CxHxW
            x = torch.from_numpy(np.ascontiguousarray(arr))
        new_h, new_w = get_resize_size(x, self.max_size)
        lead = x.shape[:-2]
        flat = x.reshape(1, -1, *x.shape[-2:])
        out = F.interpolate(flat, size=(new_h, new_w), mode=_MODES[self.interpolation],
                            align_corners=False, antialias=True)
        out = out.reshape(*lead, new_h, new_w)
        return out if is_tensor else out.numpy()

    def __repr__(self):
        return f"{self.__class__.__name__}(max_size={self.max_size}, interpolation={self.interpolation})"


class ImageNorm:
    """Per-channel (x/255 - mean)/std (data_utils.py:260-280)."""

    def __init__(self, mean, std):
        self.mean = np.asarray(mean, np.float32).reshape(-1, 1, 1)
        self.std = np.asarray(std, np.float32).reshape(-1, 1, 1)

    def __call__(self, img):
        if isinstance(img, torch.Tensor):
            x = img.float()
            mean = torch.from_numpy(self.mean).to(x.device)
            std = torch.from_numpy(self.std).to(x.device)
            if x.max().item() > 1.0 and float(self.mean.max()) <= 1.0:
                x = x / 255.0
            return (x - mean) / std
        arr = np.asarray(img, np.float32)
        if arr.max() > 1.0 and float(self.mean.max()) <= 1.0:
            arr = arr / 255.0
        return (arr - self.mean) / self.std


def get_imagenet_transform(min_size: int = 600, max_size: int = 1000):
    """Resize + ImageNet normalization chain (data_utils.py:246-257)."""
    if min_size != 600:
        warnings.warn("Warning: min_size is not used in image transform, setting min_size will have no effect.")
    resize = ImageResize(max_size, "bilinear")
    norm = ImageNorm(mean=[0.485, 0.456, 0.406], std=[0.229, 0.224, 0.225])
    return lambda img: norm(resize(img))


# ----------------------------------------------------------------------
def load_decompress_img_from_lmdb_value(lmdb_value: bytes) -> np.ndarray:
    """Decode encoded image bytes (as the reference's LMDB stores them) to an
    HxWx3 uint8 array (data_utils.py:367-380). Needs PIL."""
    import io

    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("PIL is required to decode raw image bytes") from e
    img = Image.open(io.BytesIO(lmdb_value))
    return np.asarray(img.convert("RGB"))
