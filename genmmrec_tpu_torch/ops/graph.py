"""Sparse graph operators (counterpart of ``genmmrec_tpu/ops/graph.py``).

A ``SparseGraph`` holds row-sorted COO edges plus a CSR row pointer built
once per graph, so the SpMM kernel (K1, ``ops/segment.py``) walks rows
directly. The JAX package's VMEM span planners (``pallas_span``,
``pallas_plan``) have no counterpart: the row pointer replaces them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from genmmrec_tpu_torch.ops.segment import segment_spmm


@dataclasses.dataclass(frozen=True)
class SparseGraph:
    rows: torch.Tensor  # (nnz,) int32, ascending when `sorted`
    cols: torch.Tensor  # (nnz,) int32
    vals: torch.Tensor  # (nnz,) float32
    row_ptr: torch.Tensor  # (n_rows + 1,) int32 CSR offsets, valid when `sorted`
    n_rows: int
    n_cols: int
    sorted: bool = True
    # value-symmetric square graph (Aᵀ == A)
    symmetric: bool = False

    @property
    def nnz(self) -> int:
        return self.rows.shape[0]


def sorted_graph(rows, cols, vals, n_rows: int, n_cols: int, symmetric: bool = False) -> SparseGraph:
    """SparseGraph from row-sorted edge tensors; builds the row pointer on
    the edges' device with ``torch.searchsorted``."""
    rows = rows.to(torch.int32).contiguous()
    bounds = torch.arange(n_rows + 1, dtype=torch.int32, device=rows.device)
    row_ptr = torch.searchsorted(rows, bounds, out_int32=True)
    return SparseGraph(
        rows=rows,
        cols=cols.to(torch.int32).contiguous(),
        vals=vals.to(torch.float32).contiguous(),
        row_ptr=row_ptr,
        n_rows=n_rows,
        n_cols=n_cols,
        symmetric=symmetric,
    )


def spmm(g: SparseGraph, x: torch.Tensor) -> torch.Tensor:
    """Sparse @ dense: (n_rows, n_cols) @ (n_cols, d) -> (n_rows, d)."""
    if g.sorted:
        return segment_spmm(g.row_ptr, g.cols, g.vals, x.contiguous(), g.n_rows)
    if x.is_cuda:
        raise ValueError("spmm on CUDA needs a row-sorted graph")
    out = torch.zeros(g.n_rows, x.shape[1], dtype=x.dtype, device=x.device)
    return out.index_add_(0, g.rows.long(), g.vals[:, None] * x[g.cols.long()])


def spmm_multi(g: SparseGraph, xs):
    """SpMM of several operands over the same graph in one column-concatenated pass."""
    dims = [x.shape[1] for x in xs]
    out = spmm(g, torch.cat(xs, dim=1))
    return list(torch.split(out, dims, dim=1))


def bipartite_norm_adj(
    users: np.ndarray,
    items: np.ndarray,
    n_users: int,
    n_items: int,
    device,
    eps: float = 1e-7,
    weighted: bool = False,
) -> SparseGraph:
    """Symmetric-normalized (N+M)×(N+M) adjacency D^{-1/2} A D^{-1/2}, built
    on the host from the train edge list with the JAX package's numpy code:
    degree = row count + eps, duplicate (u, i) pairs collapsed unless
    ``weighted``."""
    N = n_users + n_items
    pairs, counts = np.unique(
        np.stack([users.astype(np.int64), items.astype(np.int64)], axis=1),
        axis=0, return_counts=True,
    )
    uu, ii = pairs[:, 0], pairs[:, 1] + n_users
    rows = np.concatenate([uu, ii])
    cols = np.concatenate([ii, uu])
    w = (
        np.concatenate([counts, counts]).astype(np.float64)
        if weighted
        else np.ones(rows.shape[0], np.float64)
    )
    deg = np.bincount(rows, weights=w, minlength=N) + eps
    d_inv_sqrt = np.power(deg, -0.5)
    vals = (w * d_inv_sqrt[rows] * d_inv_sqrt[cols]).astype(np.float32)
    order = np.argsort(rows, kind="stable")
    rows_s = rows[order]
    row_ptr = np.searchsorted(rows_s, np.arange(N + 1)).astype(np.int32)
    to = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
    return SparseGraph(
        rows=to(rows_s, torch.int32),
        cols=to(cols[order], torch.int32),
        vals=to(vals[order], torch.float32),
        row_ptr=to(row_ptr, torch.int32),
        n_rows=N,
        n_cols=N,
        symmetric=True,
    )
