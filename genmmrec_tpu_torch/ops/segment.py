"""K1 and K2: sorted segment-sum SpMM over row-sorted edges, forward and backward.

Counterpart of ``genmmrec_tpu/ops/segment_pallas.py``. Both kernels compute
``out[r] = Σ_{e : rows[e] = r} vals[e]·x[cols[e]]`` with the gather fused
in, without atomics, in a summation order fixed by the edge order, so two
launches give bit-equal results. Their sources say what bounds them and how
they are laid out.

- K1, ``genmmrec_tpu_torch/csrc/segment_sum.cu`` (``sorted_segment_sum`` and
  ``spmm_symmetric``, Pallas kernel ``_segsum_kernel``): the kernel owns
  CSR rows. A team of 8 to 32 lanes sums a row of at most ``LONG_ROW``
  edges, with the edge ids staged by the team and eight gathers in flight
  a lane; a longer row is summed by a thread block or, past 1,024 edges, by
  a cluster of eight, a contiguous slice of its edges a team, the partial
  sums added in team and block order through (distributed) shared memory. The list of long
  rows is a property of the graph, built once with its row pointer
  (``long_row_plan``). ``segment_spmm`` forward, ``segment_spmm_backward``
  on a cotangent.
- K2, ``genmmrec_tpu_torch/csrc/segment_blocked.cu``
  (``sorted_segment_sum_blocked`` and ``spmm_symmetric_blocked``, Pallas
  kernel ``_segsum_kernel_blocked``): the edges are cut into fixed-size
  chunks, a row cut by a chunk boundary is put together by a second small
  kernel in chunk order. ``segment_spmm_blocked`` forward,
  ``segment_spmm_blocked_backward`` on a cotangent.

Which kernel a graph takes is a static fact of the graph, decided once when
it is built (``takes_blocked``): K2 when one 64-wide float32 operand over
its rows outgrows ``L2_BYTES``, the counterpart of the reference's
``_VMEM_BUDGET`` rule. A graph under that size stays on K1, however skewed
(DiffMM's regenerated modal graphs on Amazon-baby hold one row of 14,106
edges: a long row of the plan).

``spmm_symmetric`` and ``spmm_sorted`` are the differentiable products,
over either kernel: the forward is the kernel, the x-gradient ``Aᵀḡ`` the
kernel again, on the same edges for a value-symmetric graph (Aᵀ = A, the
reference's ``_sym_bwd``/``_sym_blk_bwd``) and on the graph's transposed
CSR otherwise (the reference's ``_bwd`` is a gather plus XLA's scatter).
The vals-gradient ``Σ_d x[cols]·ḡ[rows]`` stays plain PyTorch, as the
reference leaves it to XLA outside the kernel, and is computed only when
asked for.

Every wrapper takes its plain PyTorch version for tensors on the CPU and
launches its kernel otherwise, or raises. Launches are counted apart:
``<wrapper>.launches``.
"""

from __future__ import annotations

import torch

from genmmrec_tpu_torch.ops import _build

# The H100's L2 cache. A graph whose 64-wide float32 operand over its rows is
# larger takes K2 (Amazon-elec's 255,404 rows: 65 MB; Amazon-baby's 26,495:
# 6.8 MB).
L2_BYTES = 50 * 1024 * 1024
_PLAN_WIDTH = 64


def takes_blocked(n_rows: int) -> bool:
    """Whether a graph of ``n_rows`` rows propagates through K2."""
    return n_rows * _PLAN_WIDTH * 4 > L2_BYTES


# A row of more edges than this is a long row: K1's teams skip it and a
# thread block, or a cluster of them, sums it. 64 edges are at most eight
# batches of gathers for the one team that walks a shorter row; the kernel's
# time on the DiffMM-baby graphs is flat between 32 and 64 and rises past 96.
LONG_ROW = 64


def long_row_plan(row_ptr: torch.Tensor, nnz: int) -> torch.Tensor:
    """K1's list of long rows: the ids of the rows of more than ``LONG_ROW``
    edges, ascending, then -1 up to the fixed length ``nnz // (LONG_ROW + 1)
    + 1`` (no graph of ``nnz`` edges has more long rows, and the last entry
    is always -1). Tensor operations on the row pointer's device; the fixed
    length spares the read-back of the count."""
    slots = nnz // (LONG_ROW + 1) + 1
    is_long = (row_ptr[1:] - row_ptr[:-1]) > LONG_ROW
    # a long row goes to its rank among the long rows, every other row to a
    # spare slot past the end
    dest = torch.where(is_long, torch.cumsum(is_long, 0) - 1, slots)
    ids = torch.arange(is_long.shape[0], dtype=torch.int32, device=row_ptr.device)
    plan = torch.full((slots + 1,), -1, dtype=torch.int32, device=row_ptr.device)
    return plan.scatter_(0, dest, ids)[:slots].contiguous()


def segment_spmm_plain(row_ptr, cols, vals, x, n_rows: int) -> torch.Tensor:
    """``out[r] = Σ_{e ∈ [row_ptr[r], row_ptr[r+1])} vals[e]·x[cols[e]]``."""
    rows = torch.repeat_interleave(
        torch.arange(n_rows, device=x.device), row_ptr[1:] - row_ptr[:-1]
    )
    return segment_spmm_blocked_plain(rows, cols, vals, x, n_rows)


def segment_spmm_blocked_plain(rows, cols, vals, x, n_rows: int) -> torch.Tensor:
    """``out[r] = Σ_{e : rows[e] = r} vals[e]·x[cols[e]]``; rows without edges are zero."""
    out = torch.zeros(n_rows, x.shape[1], dtype=x.dtype, device=x.device)
    return out.index_add_(0, rows.long(), vals[:, None] * x[cols.long()])


def _check_operands(what: str, x, n_rows: int, row_ptr, cols, vals, rows=None) -> int:
    """Raise on anything the kernels do not take; returns d."""
    d = x.shape[1] if x.dim() == 2 else -1
    named = [("row_ptr", row_ptr, torch.int32), ("cols", cols, torch.int32), ("vals", vals, torch.float32),
             ("x", x, torch.float32)]
    if rows is not None:
        named.append(("rows", rows, torch.int32))
    for name, t, dtype in named:
        if t.device != x.device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous {dtype} tensor on {x.device}")
    if d <= 0 or d % 4 or d > 512 or x.data_ptr() % 16:
        raise ValueError(f"{what}: x must be 2-D, 16-byte aligned, with d % 4 == 0 and d <= 512; got {tuple(x.shape)}")
    if row_ptr.shape != (n_rows + 1,) or cols.dim() != 1 or cols.shape != vals.shape:
        raise ValueError(f"{what}: row_ptr must be (n_rows + 1,), cols and vals (nnz,)")
    if rows is not None and rows.shape != cols.shape:
        raise ValueError(f"{what}: rows must be (nnz,)")
    return d


def _launch(row_ptr, cols, vals, x, n_rows: int, long_rows, what: str) -> torch.Tensor:
    """Check the operands and launch K1 on x's device; raises on anything the
    kernel does not take or on a CUDA error. Counts nothing. Without the
    graph's ``long_rows`` the list is built here, a few small launches."""
    d = _check_operands(what, x, n_rows, row_ptr, cols, vals)
    nnz = cols.shape[0]
    if long_rows is None:
        long_rows = long_row_plan(row_ptr, nnz)
    slots = nnz // (LONG_ROW + 1) + 1
    if (long_rows.device != x.device or long_rows.dtype != torch.int32 or not long_rows.is_contiguous()
            or long_rows.shape != (slots,)):
        raise ValueError(f"{what}: long_rows must be a contiguous int32 ({slots},) tensor on {x.device}")
    out = torch.empty(n_rows, d, dtype=torch.float32, device=x.device)
    _build.launch(
        "segment_spmm_f32", what, x.device,
        row_ptr.data_ptr(), cols.data_ptr(), vals.data_ptr(), x.data_ptr(), out.data_ptr(),
        long_rows.data_ptr(), slots, LONG_ROW, n_rows, d,
    )
    return out


def _launch_blocked(row_ptr, rows, cols, vals, x, n_rows: int, what: str) -> torch.Tensor:
    """The same for K2: the main kernel and the combine of the rows cut by a
    chunk boundary, over a (n_chunks, 2, d) scratch of partial sums. The
    kernel writes every row of the output, the rows without edges as zeros."""
    d = _check_operands(what, x, n_rows, row_ptr, cols, vals, rows)
    nnz = cols.shape[0]
    if nnz == 0:
        return torch.zeros(n_rows, d, dtype=torch.float32, device=x.device)
    if nnz > 2**31 - 1024:
        raise ValueError(f"{what}: {nnz} edges exceed the kernel's 32-bit edge offsets")
    out = torch.empty(n_rows, d, dtype=torch.float32, device=x.device)
    n_chunks = -(-nnz // _build.library().segment_spmm_blocked_chunk())
    part = torch.empty(n_chunks, 2, d, dtype=torch.float32, device=x.device)
    _build.launch(
        "segment_spmm_blocked_f32", what, x.device,
        row_ptr.data_ptr(), rows.data_ptr(), cols.data_ptr(), vals.data_ptr(), x.data_ptr(),
        out.data_ptr(), part.data_ptr(), nnz, n_rows, d,
    )
    return out


def _refuse_grad(what: str, vals, x) -> None:
    if torch.is_grad_enabled() and (x.requires_grad or vals.requires_grad):
        raise RuntimeError(
            f"{what} is the forward kernel alone and records no gradient on the card: "
            "go through ops.graph.spmm, spmm_symmetric or spmm_sorted"
        )


def segment_spmm(row_ptr, cols, vals, x, n_rows: int, long_rows=None) -> torch.Tensor:
    """K1. CSR SpMM: (n_rows, n_cols) sparse @ (n_cols, d) dense → (n_rows, d) f32.
    ``long_rows`` is the graph's ``long_row_plan``."""
    if x.device.type == "cpu":
        return segment_spmm_plain(row_ptr, cols, vals, x, n_rows)
    _refuse_grad("segment_spmm", vals, x)
    out = _launch(row_ptr, cols, vals, x, n_rows, long_rows, "segment_spmm")
    segment_spmm.launches += 1
    return out


def segment_spmm_backward(row_ptr, cols, vals, out_bar, n_rows: int, long_rows=None) -> torch.Tensor:
    """K1 on an output cotangent: the x-gradient, given the edges of Aᵀ and
    their ``long_row_plan``.

    ``out_bar`` may arrive as a stride-0 expansion (the backward of a sum) or
    another non-contiguous view; it is made contiguous before the checks."""
    out_bar = out_bar.contiguous()
    if out_bar.device.type == "cpu":
        return segment_spmm_plain(row_ptr, cols, vals, out_bar, n_rows)
    out = _launch(row_ptr, cols, vals, out_bar, n_rows, long_rows, "segment_spmm_backward")
    segment_spmm_backward.launches += 1
    return out


def segment_spmm_blocked(row_ptr, rows, cols, vals, x, n_rows: int) -> torch.Tensor:
    """K2. The same product as ``segment_spmm``, cut by edges instead of rows."""
    if x.device.type == "cpu":
        return segment_spmm_blocked_plain(rows, cols, vals, x, n_rows)
    _refuse_grad("segment_spmm_blocked", vals, x)
    out = _launch_blocked(row_ptr, rows, cols, vals, x, n_rows, "segment_spmm_blocked")
    segment_spmm_blocked.launches += 1
    return out


def segment_spmm_blocked_backward(row_ptr, rows, cols, vals, out_bar, n_rows: int) -> torch.Tensor:
    """K2 on an output cotangent (made contiguous first): the x-gradient,
    given the edges of Aᵀ."""
    out_bar = out_bar.contiguous()
    if out_bar.device.type == "cpu":
        return segment_spmm_blocked_plain(rows, cols, vals, out_bar, n_rows)
    out = _launch_blocked(row_ptr, rows, cols, vals, out_bar, n_rows, "segment_spmm_blocked_backward")
    segment_spmm_blocked_backward.launches += 1
    return out


segment_spmm.launches = 0
segment_spmm_backward.launches = 0
segment_spmm_blocked.launches = 0
segment_spmm_blocked_backward.launches = 0


class _Spmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, row_ptr, rows, cols, vals, x, n_rows, blocked, transpose, long_rows):
        # autograd is off inside forward, so the forward-only wrappers take
        # the operands even when they require grad
        if blocked:
            out = segment_spmm_blocked(row_ptr, rows, cols, vals, x, n_rows)
        else:
            out = segment_spmm(row_ptr, cols, vals, x, n_rows, long_rows)
        # x is needed only for the vals-gradient
        ctx.save_for_backward(row_ptr, rows, cols, vals, x if ctx.needs_input_grad[3] else None)
        ctx.n_rows, ctx.blocked, ctx.transpose, ctx.long_rows = n_rows, blocked, transpose, long_rows
        return out

    @staticmethod
    def backward(ctx, out_bar):
        row_ptr, rows, cols, vals, x = ctx.saved_tensors
        x_bar = vals_bar = None
        if ctx.needs_input_grad[4]:
            # the edges of Aᵀ: the graph's own when it is symmetric
            own = (row_ptr, rows, cols, vals, ctx.n_rows, ctx.blocked, ctx.long_rows)
            t_row_ptr, t_rows, t_cols, t_vals, t_n_rows, t_blocked, t_long = own if ctx.transpose is None else ctx.transpose()
            if t_blocked:
                x_bar = segment_spmm_blocked_backward(t_row_ptr, t_rows, t_cols, t_vals, out_bar, t_n_rows)
            else:
                x_bar = segment_spmm_backward(t_row_ptr, t_cols, t_vals, out_bar, t_n_rows, t_long)
        if ctx.needs_input_grad[3]:
            vals_bar = (x[cols.long()] * out_bar[rows.long()]).sum(-1)
        return None, None, None, vals_bar, x_bar, None, None, None, None


def spmm_symmetric(row_ptr, rows, cols, vals, x, n_rows: int, blocked: bool = False, long_rows=None) -> torch.Tensor:
    """Differentiable SpMM for a value-symmetric, row-sorted graph, over K1
    (with the graph's ``long_row_plan``) or, with ``blocked``, K2."""
    return _Spmm.apply(row_ptr, rows, cols, vals, x, n_rows, blocked, None, long_rows)


def spmm_sorted(
    row_ptr, rows, cols, vals, x, n_rows: int, transpose, blocked: bool = False, long_rows=None
) -> torch.Tensor:
    """Differentiable SpMM for any row-sorted graph. ``transpose()`` is
    called in the backward and gives Aᵀ as ``(row_ptr, rows, cols, vals,
    n_rows, blocked, long_rows)``, row-sorted."""
    return _Spmm.apply(row_ptr, rows, cols, vals, x, n_rows, blocked, transpose, long_rows)
