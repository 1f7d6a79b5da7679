"""Message passing on segment reductions (counterpart of ``genmmrec_tpu/ops/mp.py``).

The replacement for torch_geometric's ``MessagePassing`` and
``torch_scatter`` that MMGCN, GRCN, DualGNN (with DRAGON and COHESION) and
MVGAE use: ``out[d] = aggr_{(s, d) ∈ E} w_sd · x[s]``, plus the index
utilities (degree, self loops, edge dropout by a value mask, the softmax
over the edges into a node).

The edges of a message-passing graph are sorted by destination once, when
the model is built (``sort_edges_by_dst``), and held as a row-sorted
``SparseGraph`` with rows = dst, cols = src and unit values
(``message_graph``). ``propagate``'s ``add`` and ``mean`` are then K1
(``ops/graph.py`` ``spmm``) with the gather of ``x[src]`` inside the kernel
and the edge weights as the product's values; ``mean`` divides by the
in-degree clamped at 1 afterwards, as the reference does. The x-gradient is
K1 again: on the same edges for a graph built ``symmetric`` (a mirrored
edge set whose own values are mirrored too) when no edge weight is given,
and over the transposed CSR otherwise. The edge-weight gradient is plain
PyTorch, computed only when an edge weight requires it (``segment._Spmm``).
``max`` and ``segment_softmax`` stay plain PyTorch, as they are plain XLA in
the reference. The reference's ``chunk_span`` has no counterpart: the
graph's row pointer and list of long rows replace it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from genmmrec_tpu_torch.ops.graph import SparseGraph, sorted_graph, spmm


def degree(index: torch.Tensor, num_nodes: int, weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(num_nodes,) float32: the count (or the weight sum) of each node's entries in ``index``."""
    w = torch.ones(index.shape[0], device=index.device) if weights is None else weights
    return torch.zeros(num_nodes, dtype=w.dtype, device=index.device).index_add_(0, index.long(), w)


def sort_edges_by_dst(src: np.ndarray, dst: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The edges in the order of a stable sort by destination, on the host."""
    order = np.argsort(dst, kind="stable")
    return np.asarray(src)[order], np.asarray(dst)[order]


def message_graph(src, dst, num_nodes: int, device, vals=None, symmetric: bool = False) -> SparseGraph:
    """The dst-sorted edges ``src → dst`` as a row-sorted graph (rows = dst,
    cols = src) with unit values or ``vals``, in the edges' order.
    ``symmetric`` declares that the edge set and those values are mirrored,
    so that the backward of an unweighted ``propagate`` runs on the same
    edges."""
    to = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)
    v = torch.ones(len(dst), device=device) if vals is None else torch.as_tensor(vals, device=device)
    if bool((np.diff(np.asarray(dst)) < 0).any()):
        raise ValueError("message_graph needs edges sorted by destination (sort_edges_by_dst)")
    return sorted_graph(to(dst), to(src), v, num_nodes, num_nodes, symmetric=symmetric)


def propagate(x: torch.Tensor, g: SparseGraph, aggr: str = "add", edge_weight: Optional[torch.Tensor] = None):
    """out[d] = aggr_{(s, d)} w_sd · x[s] over ``g`` (``message_graph``):
    ``add``, ``mean`` (the sum over the in-degree clamped at 1) or ``max``
    (-inf where no edge arrives). ``edge_weight`` is in the graph's edge
    order; without it the graph's own values weight the messages."""
    if edge_weight is None:
        w = g.vals
    else:
        w = edge_weight
        g = dataclasses.replace(g, vals=edge_weight, symmetric=False)
    if aggr == "add":
        return spmm(g, x)
    if aggr == "mean":
        deg = (g.row_ptr[1:] - g.row_ptr[:-1]).to(x.dtype)
        return spmm(g, x) / deg.clamp(min=1.0)[:, None]
    if aggr == "max":
        msgs = x.index_select(0, g.cols) * w[:, None]
        out = torch.full((g.n_rows, x.shape[1]), -torch.inf, dtype=msgs.dtype, device=x.device)
        index = g.rows.long()[:, None].expand_as(msgs)
        return out.scatter_reduce(0, index, msgs, "amax", include_self=True)
    raise ValueError(f"unknown aggr {aggr}")


def add_self_loops(src: torch.Tensor, dst: torch.Tensor, num_nodes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    loops = torch.arange(num_nodes, dtype=src.dtype, device=src.device)
    return torch.cat([src, loops]), torch.cat([dst, loops])


def segment_softmax(scores: torch.Tensor, index: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Softmax over the edges grouped by ``index`` (torch_geometric.utils.softmax)."""
    index = index.long()
    seg_max = torch.full((num_segments,), -torch.inf, dtype=scores.dtype, device=scores.device)
    seg_max = seg_max.scatter_reduce(0, index, scores, "amax", include_self=True)
    ex = torch.exp(scores - seg_max.index_select(0, index))
    seg_sum = torch.zeros(num_segments, dtype=scores.dtype, device=scores.device).index_add(0, index, ex)
    return ex / seg_sum.index_select(0, index).clamp(min=1e-16)


def dropout_edge_mask(
    n_edges: int, keep_prob: float, generator: Optional[torch.Generator] = None, uniform: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """(n_edges,) 0/1 float32 mask to multiply into edge weights: 1 where a
    U[0, 1) draw is below ``keep_prob`` (``jax.random.bernoulli``'s rule).
    The draw comes from ``generator`` unless ``uniform`` gives it."""
    if uniform is None:
        if generator is None:
            raise ValueError("dropout_edge_mask needs a generator or a uniform draw")
        uniform = torch.rand(n_edges, generator=generator, device=generator.device)
    if uniform.shape != (n_edges,):
        raise ValueError(f"uniform must have shape ({n_edges},), not {tuple(uniform.shape)}")
    return (uniform < keep_prob).to(torch.float32)
