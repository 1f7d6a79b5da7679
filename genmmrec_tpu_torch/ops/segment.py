"""K1: sorted segment-sum SpMM over a CSR row pointer, forward and backward.

Counterpart of ``genmmrec_tpu/ops/segment_pallas.py`` (``sorted_segment_sum``
and ``spmm_symmetric``, whose Pallas kernel is ``_segsum_kernel``). The CUDA
kernel is ``genmmrec_tpu_torch/csrc/segment_sum.cu``; its source says what
bounds it and how it is laid out.

- ``segment_spmm``: the forward product, for any row-sorted graph. It takes
  the plain PyTorch version for tensors on the CPU and launches the kernel
  otherwise, or raises. It has no backward: an operand on the card that
  requires grad raises, since only a symmetric graph has its transpose at
  hand.
- ``spmm_symmetric``: the differentiable product for a value-symmetric
  graph (Aᵀ = A), the counterpart of ``spmm_symmetric``'s VJP. Its forward
  is K1 and its x-gradient is K1 again on the output cotangent,
  ``Aᵀḡ = Aḡ``. The vals-gradient ``Σ_d x[cols]·ḡ[rows]`` stays plain
  PyTorch, as the reference leaves it to XLA outside the kernel, and is
  computed only when asked for. On the CPU the same ``Function`` runs the
  plain forward and backward.

Forward and backward launches are counted apart: ``segment_spmm.launches``
and ``segment_spmm_backward.launches``.
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


def _launch(row_ptr, cols, vals, x, n_rows: int, what: str) -> torch.Tensor:
    """Check the operands and launch K1 on x's device; raises on anything the
    kernel does not take or on a CUDA error. Counts nothing."""
    d = x.shape[1] if x.dim() == 2 else -1
    for name, t, dtype in (
        ("row_ptr", row_ptr, torch.int32),
        ("cols", cols, torch.int32),
        ("vals", vals, torch.float32),
        ("x", x, torch.float32),
    ):
        if t.device != x.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous {dtype} tensor on {x.device}")
    if d <= 0 or d % 4 or d > 512 or x.data_ptr() % 16:
        raise ValueError(f"{what}: x must be 2-D, 16-byte aligned, with d % 4 == 0 and d <= 512; got {tuple(x.shape)}")
    if row_ptr.shape != (n_rows + 1,) or cols.dim() != 1 or cols.shape != vals.shape:
        raise ValueError(f"{what}: row_ptr must be (n_rows + 1,), cols and vals (nnz,)")
    out = torch.empty(n_rows, d, dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        rc = lib.segment_spmm_f32(
            row_ptr.data_ptr(), cols.data_ptr(), vals.data_ptr(), x.data_ptr(), out.data_ptr(),
            n_rows, d, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, rc, what)
    return out


def segment_spmm(row_ptr, cols, vals, x, n_rows: int) -> torch.Tensor:
    """CSR SpMM: (n_rows, n_cols) sparse @ (n_cols, d) dense → (n_rows, d) f32."""
    if x.device.type == "cpu":
        return segment_spmm_plain(row_ptr, cols, vals, x, n_rows)
    if torch.is_grad_enabled() and (x.requires_grad or vals.requires_grad):
        raise RuntimeError(
            "segment_spmm has no backward on the card for a graph not known to be "
            "symmetric: use spmm_symmetric for a value-symmetric graph"
        )
    out = _launch(row_ptr, cols, vals, x, n_rows, "segment_spmm")
    segment_spmm.launches += 1
    return out


def segment_spmm_backward(row_ptr, cols, vals, out_bar, n_rows: int) -> torch.Tensor:
    """x-gradient of a symmetric graph's SpMM: K1 on the output cotangent.

    ``out_bar`` may arrive as a stride-0 expansion (the backward of a sum) or
    another non-contiguous view; it is made contiguous before the checks."""
    out_bar = out_bar.contiguous()
    if out_bar.device.type == "cpu":
        return segment_spmm_plain(row_ptr, cols, vals, out_bar, n_rows)
    out = _launch(row_ptr, cols, vals, out_bar, n_rows, "segment_spmm_backward")
    segment_spmm_backward.launches += 1
    return out


segment_spmm.launches = 0
segment_spmm_backward.launches = 0


class _SymmetricSpmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, row_ptr, rows, cols, vals, x, n_rows):
        # autograd is off inside forward, so the forward-only wrapper takes
        # the operands even when they require grad
        out = segment_spmm(row_ptr, cols, vals, x, n_rows)
        # x is needed only for the vals-gradient
        ctx.save_for_backward(row_ptr, rows, cols, vals, x if ctx.needs_input_grad[3] else None)
        ctx.n_rows = n_rows
        return out

    @staticmethod
    def backward(ctx, out_bar):
        row_ptr, rows, cols, vals, x = ctx.saved_tensors
        x_bar = vals_bar = None
        if ctx.needs_input_grad[4]:
            x_bar = segment_spmm_backward(row_ptr, cols, vals, out_bar, ctx.n_rows)
        if ctx.needs_input_grad[3]:
            vals_bar = (x[cols.long()] * out_bar[rows.long()]).sum(-1)
        return None, None, None, vals_bar, x_bar, None


def spmm_symmetric(row_ptr, rows, cols, vals, x, n_rows: int) -> torch.Tensor:
    """Differentiable CSR SpMM for a value-symmetric, row-sorted graph."""
    return _SymmetricSpmm.apply(row_ptr, rows, cols, vals, x, n_rows)
