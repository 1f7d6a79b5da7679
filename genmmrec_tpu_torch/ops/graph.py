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
``ui_norm_adj``; ``SampledUIGraph`` with values recomputed per epoch), the raw interaction matrix (``interaction_matrix``), an
item-item KNN graph on the device (``knn_graph_sparse``: a float32
similarity product and K3's top-k; ``mixed_knn_graph``, the weighted union
of two modalities' graphs), the generated user-item graph of
DiffMM and GenRecV1 (``regenerated_ui_graph``, its stand-in before the
first regeneration ``placeholder_ui_graph``), and LATTICE's dense KNN
planes (``build_sim``, ``knn_graph_dense``, ``norm_laplacian_dense``),
whose top-k is K3's on the detached plane and whose values carry the
gradient, and the user co-occurrence lists of DualGNN and of the
preprocessing's user graph (``cooccurrence_topk``: count blocks from the
sparse interaction matrix and K3's top-k).
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


# the operand widths K1 and K2 take: a multiple of KERNEL_D_MULTIPLE up to
# KERNEL_MAX_D columns
KERNEL_MAX_D, KERNEL_D_MULTIPLE = 512, 4


def spmm(g: SparseGraph, x: torch.Tensor) -> torch.Tensor:
    """Sparse @ dense: (n_rows, n_cols) @ (n_cols, d) -> (n_rows, d), any
    d ≥ 1. A width the kernels do not take is padded with zero columns to a
    multiple of ``KERNEL_D_MULTIPLE`` and cut into column slices of at most
    ``KERNEL_MAX_D``, one product each, on every device; a column's sums
    keep their order, so the result equals the unsliced product."""
    d = x.shape[1]
    if d % KERNEL_D_MULTIPLE == 0 and d <= KERNEL_MAX_D:
        return _spmm(g, x)
    pad = -d % KERNEL_D_MULTIPLE
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    out = torch.cat([_spmm(g, x[:, lo : lo + KERNEL_MAX_D]) for lo in range(0, d + pad, KERNEL_MAX_D)], dim=1)
    return out[:, :d] if pad else out


def _spmm(g: SparseGraph, x: torch.Tensor) -> torch.Tensor:
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


def layer_mean(g: SparseGraph, x: torch.Tensor, n_layers: int) -> torch.Tensor:
    """LightGCN's propagation: the mean of ``x`` and its ``n_layers``
    successive products with ``g``."""
    acc = x
    for _ in range(n_layers):
        x = spmm(g, x)
        acc = acc + x
    return acc / (n_layers + 1)


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


# the left rows of one co-occurrence block
USER_GRAPH_BLOCK = 2048


def cooccurrence_topk(users, items, n_users: int, n_items: int, k: int, device, repeats: bool = False):
    """Each user's k users of most shared items, on ``device``: (nbrs (U, k)
    int64, counts (U, k) float64, -inf where the count is 0), counts
    descending, ties to the lower user id (K3's order). The counts are
    blocks of ``USER_GRAPH_BLOCK`` rows of ``L @ Rᵀ``, the diagonal zeroed:
    R is the 0/1 user-item matrix, kept sparse (a product of sparse R and
    the block's dense Lᵀ), and L is R too or, with ``repeats``, the count of
    each (user, item) row, so that a user's repeated rows count once each on
    its own side and once on the other's. A block's planes hold (n_items +
    2 n_users) × ``USER_GRAPH_BLOCK`` float32s: 0.38 GB at baby, 3.7 GB at
    elec."""
    full_precision_matmuls()
    u = torch.as_tensor(users, device=device).long()
    i = torch.as_tensor(items, device=device).long()
    pairs = torch.unique(u * n_items + i)
    r = torch.sparse_coo_tensor(
        torch.stack([pairs // n_items, pairs % n_items]), torch.ones(len(pairs), device=device),
        (n_users, n_items), is_coalesced=True, check_invariants=True,
    )
    nbrs, wts = [], []
    for lo in range(0, n_users, USER_GRAPH_BLOCK):
        hi = min(lo + USER_GRAPH_BLOCK, n_users)
        sel = (u >= lo) & (u < hi)
        left_t = torch.zeros(n_items, hi - lo, device=device)
        ones = torch.ones(1, device=device).expand(int(sel.sum()))
        left_t.index_put_((i[sel], u[sel] - lo), ones, accumulate=repeats)
        # integer counts far below 2^24, exact in float32
        co = (r @ left_t).T.contiguous()
        rows = torch.arange(hi - lo, device=device)
        co[rows, rows + lo] = 0.0
        v, idx = grouped_topk(co, k)
        nbrs.append(idx)
        wts.append(torch.where(v > 0, v.to(torch.float64), -torch.inf))
    return torch.cat(nbrs), torch.cat(wts)


class SampledUIGraph:
    """The symmetric D^{-1/2}AD^{-1/2} adjacency of the unique train pairs
    over a static edge layout ([u → i + n_users ; i + n_users → u], stably
    row-sorted), whose values are recomputed from a keep mask over the pairs:
    the per-epoch edge pruning of LayerGCN and FREEDOM. A pruned pair keeps
    its two edges at the value 0, so the graph's structure never changes."""

    def __init__(self, users: np.ndarray, items: np.ndarray, n_users: int, n_items: int, device):
        users, items = unique_ui_pairs(users, items)
        self.n_users, self.n_items, self.n_edges = n_users, n_items, len(users)
        self.users = torch.as_tensor(users, device=device)
        self.items = torch.as_tensor(items, device=device)
        N = n_users + n_items
        rows = np.concatenate([users, items + n_users])
        cols = np.concatenate([items + n_users, users])
        order = np.argsort(rows, kind="stable")
        # position of each sorted edge in [v, v], the values of both directions
        self.perm = torch.as_tensor(order, device=device)
        self.structure = sorted_graph(
            torch.as_tensor(rows[order], device=device), torch.as_tensor(cols[order], device=device),
            torch.zeros(2 * self.n_edges, device=device), N, N, symmetric=True,
        )
        # the pairs' degree weights, which the pruning samples by
        du = np.bincount(users, minlength=n_users) + 1e-7
        di = np.bincount(items, minlength=n_items) + 1e-7
        self.edge_values = torch.as_tensor(
            (np.power(du, -0.5)[users] * np.power(di, -0.5)[items]).astype(np.float32), device=device
        )

    def values(self, keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Normalized values of the kept pairs ((n_edges,) 0/1 float32; all
        of them when None), degrees + 1e-7, in the layout's edge order."""
        if keep is None:
            keep = torch.ones(self.n_edges, device=self.users.device)
        du = torch.zeros(self.n_users, device=keep.device).index_add_(0, self.users, keep) + 1e-7
        di = torch.zeros(self.n_items, device=keep.device).index_add_(0, self.items, keep) + 1e-7
        v = keep * du[self.users] ** -0.5 * di[self.items] ** -0.5
        return torch.cat([v, v])[self.perm]

    def sample_keep(self, n_keep: int, uniform: torch.Tensor, weighted: bool = True) -> torch.Tensor:
        """(n_edges,) 0/1 float32: ``n_keep`` pairs without replacement by
        Gumbel top-k over ``uniform`` ((n_edges,) U[0, 1)), in proportion to
        ``edge_values`` when ``weighted``, else uniformly; the threshold is
        the score at sorted position ``n_edges - n_keep``."""
        g = -torch.log(-torch.log(uniform + 1e-20) + 1e-20)
        scores = torch.log(self.edge_values) + g if weighted else g
        thresh = torch.sort(scores).values[self.n_edges - n_keep]
        return (scores >= thresh).to(torch.float32)

    def graph(self, vals: torch.Tensor) -> SparseGraph:
        return dataclasses.replace(self.structure, vals=vals)


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


def mixed_knn_graph(v_feat, t_feat, topk: int, image_weight: float) -> SparseGraph:
    """The multimodal item graph of FREEDOM, DRAGON and COHESION: each
    modality's ``binary_row`` KNN graph, the image graph's values times
    ``image_weight`` and the text graph's times the rest (all of it when
    there is no image graph), as one edge list (a pair in both stays two
    edges) stably row-sorted, image edges first."""
    parts = []
    if v_feat is not None:
        parts.append((knn_graph_sparse(v_feat, topk, "binary_row"), image_weight))
    if t_feat is not None:
        parts.append((knn_graph_sparse(t_feat, topk, "binary_row"), 1.0 - image_weight if parts else 1.0))
    rows, order = torch.sort(torch.cat([g.rows for g, _ in parts]), stable=True)
    cols = torch.cat([g.cols for g, _ in parts])[order]
    vals = torch.cat([g.vals * w for g, w in parts])[order]
    n = parts[0][0].n_rows
    return sorted_graph(rows, cols, vals, n, n)


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


# ----------------------------------------------------------------------
# dense KNN item-item planes (LATTICE)
DENSE_NORMS = ("sym", "rw", "none")


def build_sim(features: torch.Tensor) -> torch.Tensor:
    """(n, n) cosine similarity of the rows of ``features``: each row over
    max(its L2 norm, 1e-12), times the transpose (a float32 product)."""
    x = torch.nn.functional.normalize(features, dim=-1, eps=1e-12)
    return x @ x.T


def norm_laplacian_dense(adj: torch.Tensor, norm_type: str = "sym") -> torch.Tensor:
    """``D^-1/2 A D^-1/2`` ("sym") or ``D^-1 A`` ("rw") with D the row sums,
    a zero row staying zero; "none" returns ``adj``. The power is taken of
    the positive row sums only, so a zero row passes no NaN to the
    gradient."""
    if norm_type not in DENSE_NORMS:
        raise ValueError(f"norm_type must be one of {DENSE_NORMS}, not {norm_type!r}")
    if norm_type == "none":
        return adj
    rowsum = adj.sum(dim=-1)
    pos = rowsum > 0
    safe = torch.where(pos, rowsum, torch.ones_like(rowsum))
    if norm_type == "sym":
        d = torch.where(pos, safe.pow(-0.5), torch.zeros_like(rowsum))
        return adj * d[:, None] * d[None, :]
    d = torch.where(pos, 1.0 / safe, torch.zeros_like(rowsum))
    return adj * d[:, None]


def dense_topk_plane(sim: torch.Tensor, topk: int) -> torch.Tensor:
    """A zero plane the shape of ``sim`` holding each row's ``topk`` largest
    entries where they stand. The columns are K3's top-k of the detached
    plane (ties to the lower index, as ``lax.top_k``); the values are
    gathered from ``sim`` itself, so the gradient reaches it at the kept
    entries only."""
    _, idx = grouped_topk(sim.detach(), topk)
    return torch.zeros_like(sim).scatter(1, idx, sim.gather(1, idx))


def knn_graph_dense(sim: torch.Tensor, topk: int, norm_type: str = "sym") -> torch.Tensor:
    """Dense KNN adjacency: each row's ``topk`` largest similarities
    (``dense_topk_plane``), normalized by ``norm_laplacian_dense``."""
    return norm_laplacian_dense(dense_topk_plane(sim, topk), norm_type)
