"""The multi-device layer over ``torch.distributed`` (counterpart of
``genmmrec_tpu/parallel/mesh.py``).

The port runs one rank per process (``parallel/launch.py`` starts them).
The mesh is a (data × model) grid of ranks, rank ``r`` at row ``r //
model`` and column ``r % model``, as the JAX package reshapes its devices.
Each rank holds two process groups: the ranks of its column (the data
axis: same model index) and the ranks of its row (the model axis: same
data index).

- Training batches are split over ``data``: every rank draws the global
  batch from the same generator and keeps its contiguous ``B / data`` rows
  (``DataRows``); gradients are summed over the data axis.
- Tables are whole on every rank in the forward and the backward. Over
  ``model``, each rank keeps the optimizer moments, and takes the update,
  only for its rows of the tables ``shard_model_params`` names, then
  gathers the rows (``engine.trainer.ChainOptimizer``).
- Evaluation deals whole user chunks over ``data``; over ``model`` each
  rank scores its item shard and K3 takes its top-k there, and the shards'
  survivors merge (``sharded_topk``).

The backend is a rule: NCCL when every rank has a GPU of its own, else
gloo (ranks that share one card, and the CPU). gloo takes the layer's
collectives (all-reduce, all-gather, broadcast) on CUDA tensors itself
(``scripts/gloo_cuda_collectives.py`` on the H100, PERF.md), so no
collective copies through host memory here.
"""

from __future__ import annotations

import dataclasses
from logging import getLogger
from typing import Any, Callable, Optional, Union

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
# shard widths are multiples of this, so that a shard's bits of the packed
# mask are whole bytes
SHARD_ALIGN = 8


def shape_dims(shape: dict) -> tuple:
    """(data, model) of a ``mesh_shape`` mapping; an absent axis is 1."""
    d, m = int(shape.get(DATA_AXIS, 1)), int(shape.get(MODEL_AXIS, 1))
    if d < 1 or m < 1:
        raise ValueError(f"mesh_shape {shape} must have positive axes")
    return d, m


def mesh_dims(config, world: int) -> tuple:
    """(data, model) of ``config["mesh_shape"]`` over ``world`` ranks:
    ``null`` puts every rank on ``data``; a shape of more ranks than the
    world raises ``ValueError``."""
    shape = config["mesh_shape"] if config is not None else None
    if not shape:
        return world, 1
    d, m = shape_dims(shape)
    if d * m > world:
        raise ValueError(f"mesh_shape {shape} exceeds {world} devices")
    return d, m


def backend_for(device: Union[str, torch.device], world: int) -> str:
    """NCCL when every rank has a GPU of its own, else gloo. NCCL refuses two
    ranks on one device."""
    if torch.device(device).type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data × model) grid of ranks. ``data_group`` holds the ranks of
    this rank's column (the data axis), ``model_group`` those of its row
    (the model axis); both are None on a layout built without a process
    group. A rank past ``data · model`` is not a member."""

    data: int
    model: int
    rank: int = 0
    backend: Optional[str] = None
    data_group: Any = None
    model_group: Any = None

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def member(self) -> bool:
        return self.rank < self.data * self.model

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    @property
    def is_main(self) -> bool:
        """Global rank 0: the one rank that writes logs, checkpoints and files."""
        return self.rank == 0


def build_mesh(config=None, world: Optional[int] = None) -> Optional[Mesh]:
    """The mesh of ``config["mesh_shape"]`` over the process group's ranks.

    In a single process with no process group, a shape of one rank (or
    ``null``) gives None: the code paths are exactly those of one device.
    Given ``world`` without a process group, the layout alone (no groups),
    for inspection. In a process group every rank must call it, in the same
    order: it creates the row and column groups. Fewer ranks than the world
    use the first ``data · model``, as the JAX package uses the first
    devices."""
    if not dist.is_initialized():
        d, m = mesh_dims(config, 1 if world is None else world)
        return None if d * m == 1 else Mesh(d, m)
    world = dist.get_world_size()
    d, m = mesh_dims(config, world)
    rank = dist.get_rank()
    groups = {}
    for c in range(m):  # columns: the data axis
        g = dist.new_group([r * m + c for r in range(d)])
        if rank < d * m and rank % m == c:
            groups["data"] = g
    for r in range(d):  # rows: the model axis
        g = dist.new_group([r * m + c for c in range(m)])
        if rank < d * m and rank // m == r:
            groups["model"] = g
    mesh = Mesh(d, m, rank, dist.get_backend(), groups.get("data"), groups.get("model"))
    if rank == 0:
        getLogger().info("mesh %s over %d of %d ranks, backend %s", mesh.shape, d * m, world, mesh.backend)
    return mesh


def axis_size(mesh: Optional[Mesh], axis: str) -> int:
    return 1 if mesh is None else getattr(mesh, axis)


def model_axis_size(mesh: Optional[Mesh]) -> int:
    return axis_size(mesh, MODEL_AXIS)


def pad_to_multiple(n: int, m: int) -> int:
    return -(-n // m) * m


# -- collectives -------------------------------------------------------------
def _group(mesh: Mesh, axis: str):
    return mesh.data_group if axis == DATA_AXIS else mesh.model_group


def all_reduce(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Sum ``t`` over ``axis``, in place; returns ``t``."""
    if getattr(mesh, axis) > 1:
        dist.all_reduce(t, group=_group(mesh, axis))
    return t


def all_gather(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """(size · rows, ...): ``t`` of every rank of ``axis``, stacked along
    dim 0 in axis order. Every rank passes the same shape."""
    size = getattr(mesh, axis)
    if size == 1:
        return t
    src = t.contiguous()
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=_group(mesh, axis))
    return torch.cat(parts)


def broadcast_(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``t`` of global rank 0 on every rank of the mesh, in place: down each
    column from its row-0 rank, then along each row from its column-0 rank."""
    if mesh.data > 1:
        dist.broadcast(t, mesh.model_rank, group=mesh.data_group)
    if mesh.model > 1:
        dist.broadcast(t, mesh.data_rank * mesh.model, group=mesh.model_group)
    return t


def barrier(mesh: Optional[Mesh]) -> None:
    """Every rank of the mesh waits for every other: down each column, then
    along each row (so each rank waits for global rank 0 too)."""
    if mesh is None:
        return
    if mesh.data > 1:
        dist.barrier(group=mesh.data_group)
    if mesh.model > 1:
        dist.barrier(group=mesh.model_group)


def replicated(tree, mesh: Optional[Mesh]):
    """Broadcast every tensor of ``tree`` (tensors, dicts, sequences and
    dataclasses such as ``SparseGraph``) from global rank 0, in place, so
    that every rank holds rank 0's values bit for bit; returns ``tree``."""
    if mesh is None or mesh.data * mesh.model == 1:
        return tree
    if torch.is_tensor(tree):
        with torch.no_grad():
            broadcast_(tree.data if isinstance(tree, torch.nn.Parameter) else tree, mesh)
    elif isinstance(tree, dict):
        for v in tree.values():
            replicated(v, mesh)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            replicated(v, mesh)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            replicated(getattr(tree, f.name), mesh)
    return tree


class _SumOver(torch.autograd.Function):
    """An all-reduce sum over the data axis that carries the gradient: every
    rank's loss adds its share, so the cotangent of a rank's input is the
    sum of every rank's cotangent of the output."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return all_reduce(x.clone(), mesh, DATA_AXIS)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.mesh, DATA_AXIS), None


class _GatherRows(torch.autograd.Function):
    """An all-gather of rows over the data axis that carries the gradient:
    the cotangent of a rank's rows is its slice of the sum of every rank's
    cotangent."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.rows = mesh, x.shape[0]
        return all_gather(x, mesh, DATA_AXIS)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce(g.contiguous().clone(), ctx.mesh, DATA_AXIS)
        i = ctx.mesh.data_rank
        return g[i * ctx.rows : (i + 1) * ctx.rows], None


def sum_over(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Differentiable all-reduce sum over the data axis."""
    return _SumOver.apply(x, mesh)


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Differentiable all-gather of ``x``'s rows over the data axis."""
    return _GatherRows.apply(x, mesh)


# -- the data axis: data_sharding ---------------------------------------------
class DataRows:
    """This rank's rows of a global batch of ``n`` rows split over the data
    axis: the contiguous ``n / data`` rows ``[lo, hi)``, as ``P("data")``
    lays them.

    A loss computed with it is this rank's share of the global loss: the
    sum of its rows' terms over the global denominator (``count``), plus a
    term over whole tables times ``share``; a term that couples rows takes
    the other ranks' rows from ``gather``. The shares of every rank sum to
    the global loss, and so the gradients, summed over the data axis."""

    def __init__(self, mesh: Mesh, n: int):
        if n % mesh.data:
            raise ValueError(f"a batch of {n} rows does not split over a data axis of {mesh.data}")
        self.mesh, self.n = mesh, n
        per = n // mesh.data
        self.lo, self.hi = mesh.data_rank * per, (mesh.data_rank + 1) * per
        self.share = 1.0 / mesh.data

    def local(self, x):
        """This rank's rows of a global per-row tensor, or of each tensor of
        a tuple, list or dict (None stays None)."""
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: self.local(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(self.local(v) for v in x)
        return x[self.lo : self.hi]

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the data axis, carrying the gradient."""
        return sum_over(x, self.mesh)

    def count(self, x: torch.Tensor) -> torch.Tensor:
        """A denominator summed over the data axis (no gradient)."""
        return all_reduce(x.detach().clone(), self.mesh, DATA_AXIS)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global rows of a per-row tensor, carrying the gradient."""
        return gather_rows(x, self.mesh)


def data_sharding(mesh: Optional[Mesh], n: int) -> Optional[DataRows]:
    """The rows of a global batch of ``n`` that this rank owns, or None off
    a data axis. A batch that does not split over the axis stays whole on
    every rank, with a warning (the JAX trainer's rule): every rank then
    trains the whole batch, and the caller reduces nothing over the axis."""
    if mesh is None or mesh.data == 1:
        return None
    if n % mesh.data:
        getLogger().warning(
            "train_batch_size %d not divisible by data axis %d — batch sharding DISABLED for this run", n, mesh.data
        )
        return None
    return DataRows(mesh, n)


def reduce_grads(params, mesh: Optional[Mesh]) -> None:
    """Sum the gradients of ``params`` over the data axis in one coalesced
    all-reduce. A parameter without a gradient takes a zero one, so that
    every rank reduces the same buffer."""
    if mesh is None or mesh.data == 1:
        return
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    all_reduce(flat, mesh, DATA_AXIS)
    off = 0
    for p in params:
        p.grad.copy_(flat[off : off + p.numel()].view_as(p.grad))
        off += p.numel()


def deal(n_chunks: int, mesh: Optional[Mesh]) -> list:
    """The chunk ids this rank takes when ``n_chunks`` whole chunks are
    dealt over the data axis: chunk ``i`` to data rank ``i % data``."""
    d = axis_size(mesh, DATA_AXIS)
    return list(range(mesh.data_rank if d > 1 else 0, n_chunks, d))


def gather_chunks(mine: list, n_chunks: int, mesh: Mesh, like: torch.Tensor) -> torch.Tensor:
    """(n_chunks, *like.shape): every chunk's result on every rank, in chunk
    order, from the results of this rank's dealt chunks (``deal``), each of
    ``like``'s shape and type."""
    d = mesh.data
    per = -(-n_chunks // d)
    buf = like.new_zeros((per, *like.shape))
    for j, r in enumerate(mine):
        buf[j] = r
    got = all_gather(buf[None], mesh, DATA_AXIS)  # (d, per, ...)
    return torch.stack([got[i % d, i // d] for i in range(n_chunks)])


# -- the model axis: shard_model_params ---------------------------------------
def shard_model_params(model, mesh: Optional[Mesh]) -> dict:
    """name -> (lo, hi): the rows of each qualifying parameter whose
    optimizer moments and update this model rank owns. The rule is the JAX
    package's: a 2-D leaf of ``n_users``, ``n_items`` or ``n_users +
    n_items`` rows, a 1-D leaf of ``n_items``, split evenly over the model
    axis. Empty off a model axis."""
    m = model_axis_size(mesh)
    if m <= 1:
        return {}
    n_items = int(model.n_items)
    table_rows = {int(model.n_users), n_items, int(model.n_users) + n_items}
    out = {}
    for name, p in model.named_parameters():
        rows = p.shape[0] if p.dim() in (1, 2) else None
        if (p.dim() == 2 and rows in table_rows or p.dim() == 1 and rows == n_items) and rows % m == 0:
            per = rows // m
            out[name] = (mesh.model_rank * per, (mesh.model_rank + 1) * per)
    return out


def item_sharded(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The (B, n_items) vectors of the diffusion models, as they are: they
    stay whole on each rank, since the tables are whole in the forward (in
    the JAX package a layout hint over ``model`` with no effect on values).
    Splitting the denoisers' projections over the model axis is later
    work."""
    return x


# -- sharded_topk ----------------------------------------------------------
def shard_bounds(n: int, shards: int) -> list:
    """[(lo, hi)] of ``shards`` item shards of ``n`` columns: widths of
    ``ceil(n / shards)`` rounded up to ``SHARD_ALIGN``, the last one short
    (or empty)."""
    w = pad_to_multiple(-(-n // shards), SHARD_ALIGN)
    return [(min(s * w, n), min((s + 1) * w, n)) for s in range(shards)]


def takes_sharded(n: int, k: int, mesh: Optional[Mesh]) -> bool:
    """The JAX package's rule: a model axis of more than one rank, and at
    least ``k`` columns a shard (``n // S >= k``)."""
    S = model_axis_size(mesh)
    return S > 1 and n // S >= k


def local_topk(shard_scores: torch.Tensor, k: int, offset: int, packed_mask_cols=None):
    """K3 on one item shard → (B, k) values and global item ids. Columns
    past a short shard's width are pad slots: value ``-inf`` and an id past
    every real one, so that they never win the merge."""
    from genmmrec_tpu_torch.ops.topk import k3_topk

    B, w = shard_scores.shape
    kk = min(k, w)
    if kk > 0:
        vals, idx = k3_topk(shard_scores, kk, packed_mask_cols)
        idx = idx + offset
    else:
        vals = shard_scores.new_empty(B, 0)
        idx = torch.empty(B, 0, dtype=torch.int64, device=shard_scores.device)
    if kk < k:
        pad = k - kk
        vals = torch.cat([vals, vals.new_full((B, pad), float("-inf"))], 1)
        idx = torch.cat([idx, idx.new_full((B, pad), torch.iinfo(torch.int64).max)], 1)
    return vals, idx


def merge_topk(vals: torch.Tensor, idx: torch.Tensor, k: int):
    """The top-k of the shards' (B, S·k) survivors in global order: a larger
    value first, then the lower item id (``lax.top_k``'s rule on the whole
    row); merging by position would not give it."""
    by_id = torch.sort(idx, dim=1, stable=True)
    v = vals.gather(1, by_id.indices)
    order = torch.sort(v, dim=1, descending=True, stable=True).indices[:, :k]
    return v.gather(1, order), by_id.values.gather(1, order)


def sharded_topk(
    scores_or_fn: Union[torch.Tensor, Callable[[int, int], torch.Tensor]],
    k: int,
    mesh: Mesh,
    packed_mask=None,
    n: Optional[int] = None,
):
    """Exact masked top-k over the item catalog, item-sharded over the model
    axis. ``scores_or_fn`` is the (B, n) plane, of which each rank takes its
    columns, or ``fn(lo, hi)`` giving the (B, hi − lo) scores of this
    rank's shard (``n`` then names the width). Each model rank takes K3's
    top-k of its shard with the shard's bytes of ``packed_mask``; the (B,
    k) values and ids are gathered over the model axis and merged. Returns
    (values, indices) as ``grouped_topk``."""
    if torch.is_tensor(scores_or_fn):
        n = scores_or_fn.shape[1]
        scores_fn = lambda lo, hi: scores_or_fn[:, lo:hi].contiguous()
    else:
        scores_fn = scores_or_fn
    lo, hi = shard_bounds(n, mesh.model)[mesh.model_rank]
    mask = None
    if packed_mask is not None:
        mask = packed_mask[:, lo // 8 : lo // 8 + -(-(hi - lo) // 8)].contiguous()
    vals, idx = local_topk(scores_fn(lo, hi), k, lo, mask)
    B = vals.shape[0]
    v = all_gather(vals[None], mesh, MODEL_AXIS)  # (S, B, k)
    i = all_gather(idx[None], mesh, MODEL_AXIS)
    return merge_topk(v.permute(1, 0, 2).reshape(B, -1), i.permute(1, 0, 2).reshape(B, -1), k)
