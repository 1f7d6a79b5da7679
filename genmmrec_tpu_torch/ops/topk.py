"""K3: exact masked top-k over the rows of a score matrix.

Counterpart of ``genmmrec_tpu/ops/topk.py`` ``grouped_topk`` (whose Pallas
kernel is ``_gather_kernel``, the candidate gather of the two-stage
selection). On the card one kernel, ``genmmrec_tpu_torch/csrc/topk.cu``,
serves every width and every ``k <= 64``; its source says what bounds it
and how it is laid out.

Contract: values in descending order, ties broken by the lower index first
(``lax.top_k``'s rule). ``packed_mask`` is an optional (b, >= ceil(n/8))
uint8 bit matrix, little-endian (numpy ``packbits(axis=1,
bitorder="little")``), marking columns to exclude; excluded columns take
part with the value ``-inf``. Indices are int64.

``grouped_topk`` takes the plain PyTorch version for tensors on the CPU and
launches the kernel for CUDA tensors, or raises.
"""

from __future__ import annotations

import torch

from genmmrec_tpu_torch.ops import _build

MAX_K = 64


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


def grouped_topk(scores, k: int, packed_mask=None):
    """Exact masked top-k of a 2-D float32 score matrix → (values, indices)."""
    if not scores.is_cuda:
        return grouped_topk_plain(scores, k, packed_mask)
    if scores.dtype != torch.float32 or scores.dim() != 2 or not scores.is_contiguous():
        raise ValueError("scores must be a contiguous 2-D float32 tensor")
    b, n = scores.shape
    if not 1 <= k <= min(n, MAX_K):
        raise ValueError(f"k={k} must be in [1, {min(n, MAX_K)}]")
    mask_ptr, mask_stride = None, 0
    if packed_mask is not None:
        if (
            packed_mask.device != scores.device
            or packed_mask.dtype != torch.uint8
            or not packed_mask.is_contiguous()
            or packed_mask.dim() != 2
            or packed_mask.shape[0] != b
            or packed_mask.shape[1] < -(-n // 8)
        ):
            raise ValueError(f"packed_mask must be a contiguous uint8 ({b}, >= {-(-n // 8)}) tensor")
        mask_ptr, mask_stride = packed_mask.data_ptr(), packed_mask.shape[1]
    vals = torch.empty(b, k, dtype=torch.float32, device=scores.device)
    idx = torch.empty(b, k, dtype=torch.int64, device=scores.device)
    lib = _build.library()
    with torch.cuda.device(scores.device):
        rc = lib.masked_topk_f32(
            scores.data_ptr(), mask_ptr, mask_stride, vals.data_ptr(), idx.data_ptr(),
            b, n, k, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, rc, "grouped_topk")
    grouped_topk.launches += 1
    return vals, idx


grouped_topk.launches = 0
