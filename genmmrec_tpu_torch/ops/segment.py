"""K1: sorted segment-sum SpMM over a CSR row pointer, forward only.

Counterpart of ``genmmrec_tpu/ops/segment_pallas.py`` (``sorted_segment_sum``
and ``spmm_symmetric``, whose Pallas kernel is ``_segsum_kernel``). The CUDA
kernel is ``genmmrec_tpu_torch/csrc/segment_sum.cu``; its source says what
bounds it and how it is laid out.

``segment_spmm`` takes the plain PyTorch version for tensors on the CPU and
launches the kernel for CUDA tensors, or raises. The backward kernel comes
with training: until then a CUDA operand that requires grad raises rather
than being routed around the kernel.
"""

from __future__ import annotations

import torch

from genmmrec_tpu_torch.ops import _build


def segment_spmm_plain(row_ptr, cols, vals, x, n_rows: int) -> torch.Tensor:
    """``out[r] = Σ_{e ∈ [row_ptr[r], row_ptr[r+1])} vals[e]·x[cols[e]]``."""
    rows = torch.repeat_interleave(
        torch.arange(n_rows, device=x.device), row_ptr[1:] - row_ptr[:-1]
    )
    out = torch.zeros(n_rows, x.shape[1], dtype=x.dtype, device=x.device)
    return out.index_add_(0, rows, vals[:, None] * x[cols.long()])


def segment_spmm(row_ptr, cols, vals, x, n_rows: int) -> torch.Tensor:
    """CSR SpMM: (n_rows, n_cols) sparse @ (n_cols, d) dense → (n_rows, d) f32."""
    if not x.is_cuda:
        return segment_spmm_plain(row_ptr, cols, vals, x, n_rows)
    if x.requires_grad or vals.requires_grad:
        raise RuntimeError(
            "segment_spmm has no backward kernel yet: call it under torch.no_grad() "
            "on tensors that do not require grad"
        )
    d = x.shape[1] if x.dim() == 2 else -1
    for name, t, dtype in (
        ("row_ptr", row_ptr, torch.int32),
        ("cols", cols, torch.int32),
        ("vals", vals, torch.float32),
        ("x", x, torch.float32),
    ):
        if t.device != x.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor on {x.device}")
    if d <= 0 or d % 4 or d > 512 or x.data_ptr() % 16:
        raise ValueError(f"x must be 2-D, 16-byte aligned, with d % 4 == 0 and d <= 512; got {tuple(x.shape)}")
    if row_ptr.shape != (n_rows + 1,) or cols.dim() != 1 or cols.shape != vals.shape:
        raise ValueError("row_ptr must be (n_rows + 1,), cols and vals (nnz,)")
    out = torch.empty(n_rows, d, dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        rc = lib.segment_spmm_f32(
            row_ptr.data_ptr(), cols.data_ptr(), vals.data_ptr(), x.data_ptr(), out.data_ptr(),
            n_rows, d, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, rc, "segment_spmm")
    segment_spmm.launches += 1
    return out


segment_spmm.launches = 0
