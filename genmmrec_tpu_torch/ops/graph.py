"""Sparse graph operators (counterpart of ``genmmrec_tpu/ops/graph.py``).

A ``SparseGraph`` holds row-sorted COO edges plus a CSR row pointer built
once per graph. A graph built with ``sorted=False`` (edges in any order,
as the reference's ``segment_sum(indices_are_sorted=False)`` takes them)
multiplies through its stably row-sorted view (``row_sorted``), whose
order is computed once and kept with the graph, on every device; the sort
being stable fixes the sum's order. ``spmm`` of a sorted graph runs one of
the two SpMM kernels of ``ops/segment.py``: K1 (the kernel owns rows; the
graph carries the list of its long rows, which a cluster of thread blocks
sums) or, for a graph flagged ``blocked`` when it was built, K2
(edge-balanced chunks). Both are differentiable on the card: a
value-symmetric graph's x-gradient is the same kernel on the same edges,
any other sorted graph's the same kernel on its transposed CSR, which is
built at the first backward and kept with the graph. The JAX package's VMEM span planners (``pallas_span``,
``pallas_plan``) have no counterpart: the row pointer, the ``blocked`` flag
and the list of long rows replace them.

Graph constructors: the normalized bipartite adjacency (``bipartite_norm_adj``,
``ui_norm_adj``), the raw interaction matrix (``interaction_matrix``), an
item-item KNN graph on the device (``knn_graph_sparse``: a float32
similarity product and K3's top-k), and the generated user-item graph of
DiffMM and GenRecV1 (``regenerated_ui_graph``, its stand-in before the
first regeneration ``placeholder_ui_graph``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from genmmrec_tpu_torch.ops import segment
from genmmrec_tpu_torch.ops.precision import full_precision_matmuls
from genmmrec_tpu_torch.ops.segment import spmm_sorted, spmm_symmetric
from genmmrec_tpu_torch.ops.topk import grouped_topk


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
    # of a graph that is not row-sorted: the structure of its stably
    # row-sorted view (edge order, rows, columns, row pointer, long rows),
    # filled at first need by ``row_sorted`` and, like ``_transpose``, free
    # of values
    _row_sort: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    @property
    def nnz(self) -> int:
        return self.rows.shape[0]

    def to(self, device) -> "SparseGraph":
        move = lambda t: t.to(device)
        return dataclasses.replace(
            self, rows=move(self.rows), cols=move(self.cols), vals=move(self.vals), row_ptr=move(self.row_ptr),
            long_rows=None if self.long_rows is None else move(self.long_rows),
            _transpose={k: move(v) for k, v in self._transpose.items()},
            _row_sort={k: move(v) for k, v in self._row_sort.items()},
        )

    def row_sorted(self) -> "SparseGraph":
        """This graph, if row-sorted; else the same edges as a row-sorted
        graph, in the order of a stable sort by row. The order is computed
        once and kept; the values are gathered through it at each call, so
        they follow ``vals`` (and its autograd history)."""
        if self.sorted:
            return self
        s = self._row_sort
        if not s:
            rows, perm = torch.sort(self.rows, stable=True)
            s["perm"] = perm
            s["rows"] = rows.to(torch.int32).contiguous()
            s["cols"] = self.cols[perm].to(torch.int32).contiguous()
            s["row_ptr"] = _row_pointer(s["rows"], self.n_rows)
            s["long_rows"] = segment.long_row_plan(s["row_ptr"], self.nnz)
        # the view shares this graph's ``_transpose``, which a graph that is
        # not row-sorted leaves empty: the view's transposed structure is
        # then kept too
        return SparseGraph(
            rows=s["rows"], cols=s["cols"], vals=self.vals[s["perm"]], row_ptr=s["row_ptr"],
            n_rows=self.n_rows, n_cols=self.n_cols, symmetric=self.symmetric,
            blocked=segment.takes_blocked(self.n_rows), long_rows=s["long_rows"], _transpose=self._transpose,
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
    g = g.row_sorted()
    if g.symmetric:
        return spmm_symmetric(g.row_ptr, g.rows, g.cols, g.vals, x.contiguous(), g.n_rows, g.blocked, g.long_rows)
    # the backward's values carry no history: the vals-gradient is the
    # Function's own
    transpose = lambda: _as_operands(g.transposed(g.vals.detach()))
    return spmm_sorted(
        g.row_ptr, g.rows, g.cols, g.vals, x.contiguous(), g.n_rows, transpose, g.blocked, g.long_rows
    )


def spmm_t(g: SparseGraph, x: torch.Tensor) -> torch.Tensor:
    """Transpose SpMM: (n_cols, n_rows) @ (n_rows, d) -> (n_cols, d),
    through the transposed CSR of the graph's row-sorted view (the kernels
    need row-sorted edges); the x-gradient is then the view's own product."""
    g = g.row_sorted()
    t = g.transposed()
    own = lambda: _as_operands(dataclasses.replace(g, vals=g.vals.detach()))
    return spmm_sorted(t.row_ptr, t.rows, t.cols, t.vals, x.contiguous(), t.n_rows, own, t.blocked, t.long_rows)


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


def interaction_matrix(users: np.ndarray, items: np.ndarray, n_users: int, n_items: int, device) -> SparseGraph:
    """The raw n_users×n_items interaction matrix R: one edge of value 1 per
    train interaction, stably sorted by user; a repeated (u, i) pair stays
    two edges, which the product sums. Not symmetric."""
    ones = np.ones(len(users), np.float32)
    return _from_host(users.astype(np.int64), items.astype(np.int64), ones, n_users, n_items, device, symmetric=False)


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


# ----------------------------------------------------------------------
# the most rows of one similarity block of ``knn_graph_sparse``
KNN_BLOCK = 8192
KNN_NORMS = ("sym", "rw", "binary_row")


def knn_graph_sparse(features: torch.Tensor, topk: int, norm_type: str = "sym") -> SparseGraph:
    """Item-item KNN graph of ``features`` (n, d), on their device: each
    row's ``topk`` most cosine-similar rows (itself included), nnz = n·topk,
    not symmetric.

    The similarity is a float32 product (no TF32: the reference takes it at
    full precision) of the row-normalized features in blocks of at most
    ``KNN_BLOCK`` rows, and each row's top-k is K3's (``grouped_topk``,
    ties to the lower index, as ``lax.top_k``). The degrees and the
    normalized values are computed in float64, then stored in float32:

    - "sym": cosine values, D^-1/2 S D^-1/2 with D the weighted out-degree;
    - "rw": cosine values over the weighted out-degree of their row;
    - "binary_row": unit values, (deg[r] + 1e-7)^-1/2 (deg[c] + 1e-7)^-1/2
      with deg the out-degree count.
    """
    if norm_type not in KNN_NORMS:
        raise ValueError(f"norm_type must be one of {KNN_NORMS}, not {norm_type!r}")
    full_precision_matmuls()
    f = torch.nn.functional.normalize(features.to(torch.float32), dim=1, eps=1e-12)
    n, dev = f.shape[0], f.device
    vals, cols = [], []
    for lo in range(0, n, KNN_BLOCK):
        v, i = grouped_topk(f[lo : lo + KNN_BLOCK] @ f.T, topk)
        vals.append(v)
        cols.append(i)
    vals = torch.cat(vals).reshape(-1).to(torch.float64)
    cols = torch.cat(cols).reshape(-1)
    rows = torch.arange(n, device=dev).repeat_interleave(topk)
    if norm_type == "binary_row":
        deg = torch.bincount(rows, minlength=n).to(torch.float64)
        dis = (deg + 1e-7).pow(-0.5)
        vals = dis[rows] * dis[cols]
    else:
        deg = vals.view(n, topk).sum(dim=1)
        if norm_type == "sym":
            dis = torch.where(deg > 0, deg.pow(-0.5), 0.0)
            vals = dis[rows] * vals * dis[cols]
        else:
            vals = torch.where(deg[rows] > 0, vals / deg[rows], 0.0)
    return sorted_graph(rows, cols, vals.to(torch.float32), n, n)


def regenerated_ui_graph(
    topk_items: torch.Tensor,
    n_users: int,
    n_items: int,
    keep_rate: float,
    generator: Optional[torch.Generator] = None,
    keep=None,
) -> SparseGraph:
    """The regenerated user-item graph of DiffMM and GenRec-V1, with a
    static nnz: each user's edges to its ``topk_items`` row in both
    directions, plus a self loop on every node, symmetric-normalized by the
    edge counts. With ``keep_rate`` < 1 a paired edge dropout keeps the
    graph value-symmetric: one draw per user-item edge serves both its
    directions, one per self loop; ``keep`` gives the two bool masks
    ((U·k,), (n_users + n_items,)), else they are drawn from ``generator``
    in that order. The edges are row-sorted by a stable sort (the JAX
    package's edge order)."""
    U, k = topk_items.shape
    N = n_users + n_items
    dev = topk_items.device
    u_nodes = torch.arange(U, device=dev).repeat_interleave(k)
    i_nodes = topk_items.reshape(-1).to(torch.int64) + n_users
    loops = torch.arange(N, device=dev)
    rows = torch.cat([u_nodes, i_nodes, loops])
    cols = torch.cat([i_nodes, u_nodes, loops])
    deg = torch.bincount(rows, minlength=N).to(torch.float32)
    dis = torch.where(deg > 0, deg.pow(-0.5), torch.zeros_like(deg))
    vals = dis[rows] * dis[cols]
    if keep_rate < 1.0:
        if keep is None:
            if generator is None:
                raise ValueError("edge dropout needs a generator or keep masks")
            draw = lambda n: torch.rand(n, generator=generator, device=dev) < keep_rate
            keep = (draw(U * k), draw(N))
        m_ui, m_loop = keep
        mask = torch.cat([m_ui, m_ui, m_loop])
        vals = torch.where(mask, vals / keep_rate, torch.zeros_like(vals))
    rows, order = torch.sort(rows, stable=True)
    return sorted_graph(rows, cols[order], vals[order], N, N, symmetric=True)


def placeholder_ui_graph(
    n_users: int, n_items: int, k: int, keep_rate: float, device, generator: Optional[torch.Generator] = None
) -> SparseGraph:
    """The regenerated graph's stand-in until the first regeneration: the
    edge set of ``regenerated_ui_graph`` for item 0 as every user's top-k,
    with the user-item values 0 and the self loops' values kept."""
    topk0 = torch.zeros(n_users, k, dtype=torch.int64, device=device)
    g = regenerated_ui_graph(topk0, n_users, n_items, keep_rate, generator)
    vals = torch.where(g.rows == g.cols, g.vals, torch.zeros_like(g.vals))
    return sorted_graph(g.rows, g.cols, vals, g.n_rows, g.n_cols, symmetric=True)
