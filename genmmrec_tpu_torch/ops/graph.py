"""Sparse graph operators (counterpart of ``genmmrec_tpu/ops/graph.py``).

A ``SparseGraph`` holds row-sorted COO edges plus a CSR row pointer built
once per graph. ``spmm`` of a sorted graph runs one of the two SpMM kernels
of ``ops/segment.py``: K1 (the kernel owns rows; the graph carries the list
of its long rows, which a cluster of thread blocks sums) or, for a graph
flagged ``blocked`` when it was built, K2 (edge-balanced chunks). Both are
differentiable on the card: a value-symmetric graph's x-gradient is the same
kernel on the same edges, any other sorted graph's the same kernel on its
transposed CSR, which is built at the first backward and kept with the
graph. The JAX package's VMEM span planners (``pallas_span``,
``pallas_plan``) have no counterpart: the row pointer, the ``blocked`` flag
and the list of long rows replace them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from genmmrec_tpu_torch.ops import segment
from genmmrec_tpu_torch.ops.segment import spmm_sorted, spmm_symmetric


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
    # static choice of the SpMM kernel, made when the graph is built
    # (``segment.takes_blocked``): K2 instead of K1
    blocked: bool = False
    # K1's list of this graph's long rows (``segment.long_row_plan``), built
    # with the row pointer; None where the graph was not built by
    # ``sorted_graph``, and K1 then builds it at each launch
    long_rows: Optional[torch.Tensor] = None
    # the structure of Aᵀ (edge order, row pointer, rows, columns), filled at
    # first need by ``transposed``. It holds no values, so a copy that
    # replaces only ``vals`` may share it.
    _transpose: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    @property
    def nnz(self) -> int:
        return self.rows.shape[0]

    def to(self, device) -> "SparseGraph":
        move = lambda t: t.to(device)
        return dataclasses.replace(
            self, rows=move(self.rows), cols=move(self.cols), vals=move(self.vals), row_ptr=move(self.row_ptr),
            long_rows=None if self.long_rows is None else move(self.long_rows),
            _transpose={k: move(v) for k, v in self._transpose.items()},
        )

    def transposed(self, vals: Optional[torch.Tensor] = None) -> "SparseGraph":
        """Aᵀ as a row-sorted graph with this graph's values (or ``vals``, in
        this graph's edge order), its edges in the order of a stable sort by
        column. The structure is computed once and kept; the values are
        gathered at each call, so they follow ``vals`` (and its autograd
        history)."""
        if not self.sorted:
            raise ValueError("transposed needs a row-sorted graph")
        t = self._transpose
        if not t:
            t_rows, perm = torch.sort(self.cols, stable=True)
            t["perm"] = perm
            t["rows"] = t_rows.contiguous()
            t["cols"] = self.rows[perm].contiguous()
            t["row_ptr"] = _row_pointer(t["rows"], self.n_cols)
            t["long_rows"] = segment.long_row_plan(t["row_ptr"], self.nnz)
        return SparseGraph(
            rows=t["rows"], cols=t["cols"], vals=(self.vals if vals is None else vals)[t["perm"]],
            row_ptr=t["row_ptr"],
            n_rows=self.n_cols, n_cols=self.n_rows, symmetric=self.symmetric,
            blocked=segment.takes_blocked(self.n_cols), long_rows=t.get("long_rows"),
        )


def _row_pointer(rows: torch.Tensor, n_rows: int) -> torch.Tensor:
    """CSR offsets of ascending int32 row ids, on their device."""
    bounds = torch.arange(n_rows + 1, dtype=torch.int32, device=rows.device)
    return torch.searchsorted(rows, bounds, out_int32=True)


def sorted_graph(rows, cols, vals, n_rows: int, n_cols: int, symmetric: bool = False) -> SparseGraph:
    """SparseGraph from row-sorted edge tensors; builds the row pointer and
    the list of long rows on the edges' device and decides the graph's SpMM
    kernel."""
    rows = rows.to(torch.int32).contiguous()
    row_ptr = _row_pointer(rows, n_rows)
    return SparseGraph(
        rows=rows,
        cols=cols.to(torch.int32).contiguous(),
        vals=vals.to(torch.float32).contiguous(),
        row_ptr=row_ptr,
        n_rows=n_rows,
        n_cols=n_cols,
        symmetric=symmetric,
        blocked=segment.takes_blocked(n_rows),
        long_rows=segment.long_row_plan(row_ptr, rows.shape[0]),
    )


def _as_operands(g: SparseGraph):
    return g.row_ptr, g.rows, g.cols, g.vals, g.n_rows, g.blocked, g.long_rows


def spmm(g: SparseGraph, x: torch.Tensor) -> torch.Tensor:
    """Sparse @ dense: (n_rows, n_cols) @ (n_cols, d) -> (n_rows, d)."""
    if g.sorted and g.symmetric:
        return spmm_symmetric(g.row_ptr, g.rows, g.cols, g.vals, x.contiguous(), g.n_rows, g.blocked, g.long_rows)
    if g.sorted:
        # the backward's values carry no history: the vals-gradient is the
        # Function's own
        transpose = lambda: _as_operands(g.transposed(g.vals.detach()))
        return spmm_sorted(
            g.row_ptr, g.rows, g.cols, g.vals, x.contiguous(), g.n_rows, transpose, g.blocked, g.long_rows
        )
    if x.is_cuda:
        raise ValueError("spmm on CUDA needs a row-sorted graph")
    out = torch.zeros(g.n_rows, x.shape[1], dtype=x.dtype, device=x.device)
    return out.index_add_(0, g.rows.long(), g.vals[:, None] * x[g.cols.long()])


def spmm_t(g: SparseGraph, x: torch.Tensor) -> torch.Tensor:
    """Transpose SpMM: (n_cols, n_rows) @ (n_rows, d) -> (n_cols, d). A
    sorted graph multiplies through its transposed CSR (the kernels need
    row-sorted edges); the x-gradient is then the graph's own product."""
    if g.sorted:
        t = g.transposed()
        own = lambda: _as_operands(dataclasses.replace(g, vals=g.vals.detach()))
        return spmm_sorted(t.row_ptr, t.rows, t.cols, t.vals, x.contiguous(), t.n_rows, own, t.blocked, t.long_rows)
    if x.is_cuda:
        raise ValueError("spmm_t on CUDA needs a row-sorted graph")
    out = torch.zeros(g.n_cols, x.shape[1], dtype=x.dtype, device=x.device)
    return out.index_add_(0, g.cols.long(), g.vals[:, None] * x[g.rows.long()])


def spmm_multi(g: SparseGraph, xs):
    """SpMM of several operands over the same graph in one column-concatenated pass."""
    dims = [x.shape[1] for x in xs]
    out = spmm(g, torch.cat(xs, dim=1))
    return list(torch.split(out, dims, dim=1))


# ----------------------------------------------------------------------
def unique_ui_pairs(users: np.ndarray, items: np.ndarray):
    """Deduplicated (user, item) interaction pairs, sorted by (user, item)."""
    pairs = np.unique(np.stack([users.astype(np.int64), items.astype(np.int64)], axis=1), axis=0)
    return pairs[:, 0], pairs[:, 1]


def _from_host(rows, cols, vals, n_rows, n_cols, device, symmetric) -> SparseGraph:
    """Host edge arrays, stably sorted by row, as a graph on ``device``."""
    order = np.argsort(rows, kind="stable")
    to = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
    return sorted_graph(
        to(rows[order], torch.int32), to(cols[order], torch.int32), to(vals[order], torch.float32),
        n_rows, n_cols, symmetric=symmetric,
    )


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
    return _from_host(rows, cols, vals, N, N, device, symmetric=True)


def ui_norm_adj(users: np.ndarray, items: np.ndarray, n_users: int, n_items: int, device) -> SparseGraph:
    """Rectangular n_users×n_items D_u^{-1/2} R D_i^{-1/2}, duplicate pairs
    collapsed; not symmetric, so its backward runs over the transposed CSR."""
    uu, ii = unique_ui_pairs(users, items)
    du = np.bincount(uu, minlength=n_users).astype(np.float64)
    di = np.bincount(ii, minlength=n_items).astype(np.float64)
    with np.errstate(divide="ignore"):
        du = np.where(du > 0, np.power(du, -0.5), 0.0)
        di = np.where(di > 0, np.power(di, -0.5), 0.0)
    vals = (du[uu] * di[ii]).astype(np.float32)
    return _from_host(uu, ii, vals, n_users, n_items, device, symmetric=False)


def edge_dropout(
    g: SparseGraph,
    keep_prob: float,
    paired: bool = False,
    generator: Optional[torch.Generator] = None,
    keep: Optional[torch.Tensor] = None,
) -> SparseGraph:
    """Bernoulli edge dropout with 1/keep rescale; nnz stays, dropped edges
    get the value 0. With ``paired`` the edges are taken as [forward;
    backward] halves of a symmetrized bipartite graph and one mask of nnz/2
    draws serves both halves. The mask is drawn from ``generator`` unless
    ``keep`` gives it ((nnz/2,) when paired, else (nnz,), bool).

    The copy keeps every static field, ``symmetric`` included, after an
    unpaired dropout too, as the reference's ``dataclasses.replace`` does."""
    n = g.nnz // 2 if paired else g.nnz
    if keep is None:
        if generator is None:
            raise ValueError("edge dropout needs a generator or a keep mask")
        keep = torch.rand(n, generator=generator, device=g.vals.device) < keep_prob
    if keep.shape != (n,):
        raise ValueError(f"keep must have shape ({n},), not {tuple(keep.shape)}")
    mask = torch.cat([keep, keep]) if paired else keep
    return dataclasses.replace(g, vals=g.vals * mask.to(g.vals.dtype) / keep_prob)
