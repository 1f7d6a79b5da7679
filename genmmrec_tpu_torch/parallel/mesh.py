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
- Over ``model`` each rank holds only its rows ``[lo, hi)`` of each table
  that ``shard_model_params`` names (``hold_table_rows``, the JAX
  package's placement): the parameter, its gradient and its optimizer
  moments are those rows. Every call that reads the tables sees them whole
  through one differentiable all-gather a table, made on entry to
  ``whole_tables``; the gather's backward keeps this rank's rows of the
  cotangent. ``state_dict`` gives a held table whole and
  ``load_state_dict`` takes it whole.
- The diffusion phases of DiffMM, GenRecV1 and MVDiff split the item
  catalog over ``model`` (``ItemCols``, the JAX package's ``item_sharded``
  layout): each rank holds and computes only its columns ``[lo, hi)`` of
  every (B, n_items) vector, and only its rows of each denoiser's
  item-width out-projection and bias (``hold_item_rows``); the
  in-projection is a partial product over its columns summed over
  ``model``. The draws are made at the global width and sliced, so that
  every rank's generator stays in step with one rank's.

  The item split is one rule for the activations, the out-projections and
  the regeneration's top-k (``item_bounds``): even widths ``n / S`` where
  ``S`` divides ``n`` (the rows ``shard_model_params`` takes, 3,525 + 3,525
  for baby's 7,050), else ``shard_bounds`` (31,504 + 31,497 for elec's
  63,001). The masked evaluation keeps ``shard_bounds``, whose widths are
  whole bytes of the packed mask.

  Two sums cross the model axis (Megatron's g and f): ``ItemCols.sum``
  adds the ranks' partial values into one that every rank holds alike, and
  its backward passes the cotangent on as it is, since every rank's loss
  is the whole loss; ``ItemCols.enter`` is the identity where such a
  replicated tensor enters column-local work, and its backward sums the
  ranks' partial cotangents. The data axis instead sums shares of a loss,
  so its sum's backward sums the cotangents (``sum_over``).
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

import contextlib
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
    # in place of the process groups: an object whose ``all_reduce(t, mesh,
    # axis)`` and ``all_gather(t, mesh, axis)`` do the axis's collectives
    # (the ranks of a mesh as threads of one process, in the tests)
    exchange: Any = None

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
        if mesh.exchange is not None:
            return mesh.exchange.all_reduce(t, mesh, axis)
        dist.all_reduce(t, group=_group(mesh, axis))
    return t


def all_gather(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """(size · rows, ...): ``t`` of every rank of ``axis``, stacked along
    dim 0 in axis order. Every rank passes the same shape."""
    size = getattr(mesh, axis)
    if size == 1:
        return t
    if mesh.exchange is not None:
        return mesh.exchange.all_gather(t, mesh, axis)
    src = t.contiguous()
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=_group(mesh, axis))
    return torch.cat(parts)


def broadcast_(t: torch.Tensor, mesh: Mesh, model: bool = True) -> torch.Tensor:
    """``t`` of global rank 0 on every rank of the mesh, in place: down each
    column from its row-0 rank, then (with ``model``) along each row from
    its column-0 rank. Without ``model``, each rank of row 0's tensor on
    its column: what a tensor held as rows (``held_rows``) takes."""
    axes = [a for a, on in ((DATA_AXIS, mesh.data > 1), (MODEL_AXIS, mesh.model > 1 and model)) if on]
    for axis in axes:
        if mesh.exchange is not None:
            t.copy_(all_gather(t.reshape(1, -1), mesh, axis)[0].view_as(t))
        elif axis == DATA_AXIS:
            dist.broadcast(t, mesh.model_rank, group=mesh.data_group)
        else:
            dist.broadcast(t, mesh.data_rank * mesh.model, group=mesh.model_group)
    return t


def barrier(mesh: Optional[Mesh]) -> None:
    """Every rank of the mesh waits for every other: down each column, then
    along each row (so each rank waits for global rank 0 too)."""
    if mesh is None:
        return
    for axis in (DATA_AXIS, MODEL_AXIS):
        if getattr(mesh, axis) > 1:
            if mesh.exchange is not None:
                all_reduce(torch.zeros(1), mesh, axis)
            else:
                dist.barrier(group=_group(mesh, axis))


def replicated(tree, mesh: Optional[Mesh]):
    """Broadcast every tensor of ``tree`` (tensors, dicts, sequences and
    dataclasses such as ``SparseGraph``) from global rank 0, in place, so
    that every rank holds rank 0's values bit for bit (a parameter held as
    this rank's rows: its column's row-0 rank's rows); returns ``tree``."""
    if mesh is None or mesh.data * mesh.model == 1:
        return tree
    if torch.is_tensor(tree):
        with torch.no_grad():
            t = tree.data if isinstance(tree, torch.nn.Parameter) else tree
            broadcast_(t, mesh, model=getattr(tree, "held_rows", None) is None)
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
    """An all-reduce sum over ``axis`` that carries the gradient. Over the
    data axis every rank's loss adds its share, so the cotangent of a
    rank's input is the sum of every rank's cotangent of the output. Over
    the model axis the sum is a value every rank holds alike and every
    rank's loss is the whole loss, so the cotangent passes on as it is
    (Megatron's g); summing it there would give S times the gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_reduce(x.clone(), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        if ctx.axis == MODEL_AXIS:
            return g, None, None
        return all_reduce(g.clone(), ctx.mesh, ctx.axis), None, None


class _EnterItems(torch.autograd.Function):
    """The identity on a tensor that every model rank holds alike, where it
    enters work on this rank's item columns; the backward sums the ranks'
    partial cotangents over the model axis (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, cols):
        ctx.cols = cols
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.cols.mesh, MODEL_AXIS), None


class _ItemColumns(torch.autograd.Function):
    """Columns ``[lo, hi)`` of a weight every model rank holds whole (an
    in-projection over the items): its gradient is every rank's columns
    gathered over the model axis (``ItemCols.gather``), so every rank holds
    the whole gradient of those columns, each column from the one rank that
    reads it."""

    @staticmethod
    def forward(ctx, w, cols):
        ctx.cols = cols
        return w[:, cols.lo : cols.hi]

    @staticmethod
    def backward(ctx, g):
        return ctx.cols.gather(g, 1), None


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


def sum_over(x: torch.Tensor, mesh: Mesh, axis: str = DATA_AXIS) -> torch.Tensor:
    """Differentiable all-reduce sum over ``axis`` (``_SumOver``)."""
    return _SumOver.apply(x, mesh, axis)


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
    """name -> (lo, hi): the rows of each qualifying parameter that this
    model rank holds. The rule is the JAX package's: a 2-D leaf of
    ``n_users``, ``n_items`` or ``n_users + n_items`` rows, a 1-D leaf of
    ``n_items``, split evenly over the model axis. A parameter counts by its
    whole rows, held or not. Empty off a model axis."""
    m = model_axis_size(mesh)
    if m <= 1:
        return {}
    n_items = int(model.n_items)
    table_rows = {int(model.n_users), n_items, int(model.n_users) + n_items}
    out = {}
    for name, p in model.named_parameters():
        rows = whole_shape(p)[0] if p.dim() in (1, 2) else None
        if (p.dim() == 2 and rows in table_rows or p.dim() == 1 and rows == n_items) and rows % m == 0:
            per = rows // m
            out[name] = (mesh.model_rank * per, (mesh.model_rank + 1) * per)
    return out


def item_bounds(n: int, shards: int) -> list:
    """[(lo, hi)] of the model axis's item split: ``n / shards`` columns a
    rank where ``shards`` divides ``n`` (``shard_model_params``'s rows),
    else ``shard_bounds``."""
    if n % shards == 0:
        w = n // shards
        return [(s * w, (s + 1) * w) for s in range(shards)]
    return shard_bounds(n, shards)


class HeldRows:
    """This model rank's rows ``[lo, hi)`` of ``n`` rows split over the
    model axis by ``bounds``: the tag ``held_rows`` of a parameter held as
    its rows (``hold_item_rows``, ``hold_table_rows``). ``rows`` cuts them
    from the whole, ``gather`` gives the whole again."""

    def __init__(self, mesh: Mesh, n: int, bounds: list):
        self.mesh, self.n, self.bounds = mesh, n, bounds
        self.lo, self.hi = bounds[mesh.model_rank]
        self.width = self.hi - self.lo

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole (n, ...) tensor."""
        return x[self.lo : self.hi]

    def gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The whole of a tensor split over the rows along ``dim`` (no
        gradient): every rank's part, padded to the widest, gathered. Where
        only the last part is short (``item_bounds``' rule) the result is a
        view of the gathered tensor."""
        x = x.detach().movedim(dim, 0)
        wide = max(hi - lo for lo, hi in self.bounds)
        if x.shape[0] < wide:
            x = torch.cat([x, x.new_zeros((wide - x.shape[0], *x.shape[1:]))])
        got = all_gather(x.contiguous(), self.mesh, MODEL_AXIS)
        if all(hi - lo == wide for lo, hi in self.bounds[:-1]):
            return got[: self.n].movedim(0, dim)
        parts = [got[s * wide : s * wide + hi - lo] for s, (lo, hi) in enumerate(self.bounds)]
        return torch.cat(parts).movedim(0, dim)


class TableRows(HeldRows):
    """The even ``n / model`` rows of a table that ``shard_model_params``
    names (``hold_table_rows``): held at rest, read whole (``whole_tables``)."""

    def __init__(self, mesh: Mesh, n: int):
        per = n // mesh.model
        super().__init__(mesh, n, [(s * per, (s + 1) * per) for s in range(mesh.model)])


class ItemCols(HeldRows):
    """This model rank's columns ``[lo, hi)`` of ``n`` item columns split
    over the model axis (``item_bounds``): the item-axis counterpart of
    ``DataRows``, and of the JAX package's ``item_sharded``.

    A (B, n) vector is held as its columns (``local``), a per-item table as
    its rows (``rows``; an item-width out-projection is held so, and read as
    its rows). A sum over the items is this rank's partial sum over its
    columns, summed over the axis (``sum`` carries the gradient, ``count``
    does not); a tensor that every rank holds alike enters column-local
    work through ``enter``; a whole weight over the items is read through
    ``columns``. ``gather`` gives an item-split tensor whole, and ``topk``
    the exact top-k of a (B, n) vector from its columns."""

    def __init__(self, mesh: Mesh, n: int):
        super().__init__(mesh, n, item_bounds(n, mesh.model))

    def local(self, x):
        """This rank's columns (the last axis) of a global (..., n) tensor,
        or of each tensor of a tuple, list or dict (None stays None): a copy,
        so that the whole tensor is freed once its caller lets it go."""
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: self.local(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(self.local(v) for v in x)
        return x[..., self.lo : self.hi].contiguous()

    def planes(self, draws):
        """``draws`` (a tensor, or a dict, tuple or list of them, nested;
        None stays None) with each plane over the items, a tensor of two or
        more dimensions whose last is ``n``, cut to this rank's columns; any
        other draw (the timesteps, a hidden layer's mask) as it is. The one
        rule of which draws the item split slices: the models' draw
        functions make their planes whole and give them through it, and so
        do the trainers for draws handed in whole. A plane already cut is
        ``width < n`` wide and stays as it is."""
        if isinstance(draws, dict):
            return {k: self.planes(v) for k, v in draws.items()}
        if isinstance(draws, (tuple, list)):
            return type(draws)(self.planes(v) for v in draws)
        if torch.is_tensor(draws) and draws.dim() >= 2 and draws.shape[-1] == self.n:
            return self.local(draws)
        return draws

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of the ranks' partial ``x`` over the model axis, carrying
        the gradient (``_SumOver``: the cotangent passes on unchanged)."""
        return sum_over(x, self.mesh, MODEL_AXIS)

    def count(self, x: torch.Tensor) -> torch.Tensor:
        """A sum over the model axis without gradient."""
        return all_reduce(x.detach().clone(), self.mesh, MODEL_AXIS)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """``x``, held alike by every rank, where it enters work on this
        rank's columns (``_EnterItems``)."""
        return _EnterItems.apply(x, self)

    def columns(self, w: torch.Tensor) -> torch.Tensor:
        """This rank's columns of a weight held whole whose first ``n``
        columns are the items (``_ItemColumns``)."""
        return _ItemColumns.apply(w[:, : self.n], self)

    def topk(self, x: torch.Tensor, k: int):
        """(values, global item ids) of the top-k of each row of a (B, n)
        vector held as this rank's columns ``x``: K3 on each rank's
        columns, merged over the axis (``sharded_topk``)."""
        return sharded_topk(lambda lo, hi: x.contiguous(), k, self.mesh, n=self.n, bounds=self.bounds)

    def holds(self, ids: torch.Tensor) -> torch.Tensor:
        """(B, width) bool: True at this rank's columns of the global item
        ids ``ids`` (B, k)."""
        inside = (ids >= self.lo) & (ids < self.hi)
        at = torch.where(inside, ids - self.lo, self.width)
        out = torch.zeros(ids.shape[0], self.width + 1, dtype=torch.bool, device=ids.device)
        return out.scatter_(1, at, True)[:, : self.width]


def item_sharding(mesh: Optional[Mesh], n: int) -> Optional[ItemCols]:
    """This rank's columns of ``n`` items over the model axis, or None off a
    model axis (every code path then the one device's)."""
    if mesh is None or mesh.model == 1:
        return None
    return ItemCols(mesh, n)


def item_planes(draws, cols: Optional[ItemCols]):
    """``cols.planes(draws)``, or ``draws`` as they are off the item split."""
    return draws if cols is None else cols.planes(draws)


def whole_shape(p: torch.Tensor) -> tuple:
    """The shape of ``p`` whole: a parameter held as this rank's rows
    (``held_rows``) has ``held_rows.n`` of them."""
    held = getattr(p, "held_rows", None)
    return tuple(p.shape) if held is None else (held.n, *p.shape[1:])


def _whole_rows(module, state_dict, prefix, local_metadata):
    for name, p in module.named_parameters(recurse=False):
        held = getattr(p, "held_rows", None)
        if held is not None:
            state_dict[prefix + name] = held.gather(p, 0)


def _local_rows(module, state_dict, prefix, *args):
    for name, p in module.named_parameters(recurse=False):
        held, key = getattr(p, "held_rows", None), prefix + name
        if held is not None and key in state_dict and state_dict[key].shape[0] == held.n:
            state_dict[key] = held.rows(state_dict[key])


def _hold(module: torch.nn.Module, name: str, held: HeldRows) -> None:
    """Put this rank's rows of ``module``'s parameter ``name`` in its place:
    a new parameter of the same name, tagged ``held_rows`` (read by
    ``shard_model_params``, ``replicated``, ``copy_rows_`` and
    ``ChainOptimizer``). ``module.state_dict()`` then gives it whole (every
    model rank must call it: it gathers) and ``load_state_dict`` takes it
    whole."""
    p = module._parameters[name]
    local = torch.nn.Parameter(held.rows(p.detach()).clone(), requires_grad=p.requires_grad)
    local.held_rows = held
    setattr(module, name, local)
    if not getattr(module, "_holds_rows", False):
        module._register_state_dict_hook(_whole_rows)
        module._register_load_state_dict_pre_hook(_local_rows, with_module=True)
        module._holds_rows = True


def hold_item_rows(module: torch.nn.Module, cols: ItemCols) -> None:
    """Hold each parameter of ``module`` itself (not of its children) whose
    first dimension is the ``cols.n`` items as this rank's rows (``_hold``),
    which the item split reads as they are. A parameter held already is
    left as it is."""
    for name, p in list(module.named_parameters(recurse=False)):
        if getattr(p, "held_rows", None) is None and p.shape[0] == cols.n:
            _hold(module, name, cols)


def hold_table_rows(model: torch.nn.Module, mesh: Optional[Mesh]) -> int:
    """Hold each parameter that ``shard_model_params`` names as this model
    rank's even rows (``TableRows``, ``_hold``), but for one held already
    (the item split's); every read sees the tables whole inside
    ``whole_tables(model)``. Returns the number of parameters held as rows,
    0 off a model axis."""
    named = shard_model_params(model, mesh)
    if not named:
        return 0
    held = list(getattr(model, "_held_tables", ()))
    for prefix, module in model.named_modules():
        for name, p in list(module._parameters.items()):
            key = f"{prefix}.{name}" if prefix else name
            if key in named and getattr(p, "held_rows", None) is None:
                _hold(module, name, TableRows(mesh, p.shape[0]))
                held.append((module, name))
    model._held_tables = held
    return len(named)


def release_tables(model: torch.nn.Module) -> None:
    """Give each table that ``hold_table_rows`` holds as this rank's rows
    its whole rows back, as a parameter of the same name (a gather: every
    model rank must call it), so that ``fit`` can start a held model anew."""
    for module, name in getattr(model, "_held_tables", ()):
        p = module._parameters[name]
        setattr(module, name, torch.nn.Parameter(p.held_rows.gather(p, 0).clone(), requires_grad=p.requires_grad))
    model._held_tables = []


class _GatherTable(torch.autograd.Function):
    """A held table whole: every model rank's rows gathered. Every model
    rank's loss is the whole loss, so the ranks' cotangents of the whole
    table are equal; the backward keeps this rank's rows of it, unsummed."""

    @staticmethod
    def forward(ctx, p, held):
        ctx.held = held
        return held.gather(p, 0)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.held.lo : ctx.held.hi].contiguous(), None


@contextlib.contextmanager
def whole_tables(model: torch.nn.Module):
    """Within the block, each table of ``model`` held as this rank's rows
    (``hold_table_rows``) reads whole: every one is gathered once, on entry,
    in the same order on every rank, with the gradient enabled (a read under
    ``torch.no_grad`` and a later one share the gathered tensor), and its
    module's attribute of that name gives the gathered tensor; the held
    parameter (``named_parameters``, ``state_dict``, the optimizers) is
    untouched, and reads as itself again on exit. Every model rank must
    enter it together; a step of the parameters inside is not seen until
    the next entry. Off a model axis it does nothing."""
    held = getattr(model, "_held_tables", ())
    if not held:
        yield
        return
    with torch.enable_grad():
        whole = [(m, name, _GatherTable.apply(m._parameters[name], m._parameters[name].held_rows)) for m, name in held]
    before = [(m, name, m.__dict__.get(name)) for m, name, _ in whole]
    for m, name, t in whole:
        m.__dict__[name] = t
    try:
        yield
    finally:
        for m, name, prev in before:
            if prev is None:
                m.__dict__.pop(name, None)
            else:
                m.__dict__[name] = prev


def copy_rows_(param: torch.Tensor, whole: torch.Tensor) -> torch.Tensor:
    """Copy ``whole`` into ``param``, or its rows where ``param`` holds this
    rank's rows (``held_rows``)."""
    held = getattr(param, "held_rows", None)
    return param.copy_(whole if held is None else held.rows(whole))


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
    bounds: Optional[list] = None,
):
    """Exact masked top-k over the item catalog, item-sharded over the model
    axis. ``scores_or_fn`` is the (B, n) plane, of which each rank takes its
    columns, or ``fn(lo, hi)`` giving the (B, hi − lo) scores of this
    rank's shard (``n`` then names the width). Each model rank takes K3's
    top-k of its shard with the shard's bytes of ``packed_mask``; the (B,
    k) values and ids are gathered over the model axis and merged.
    ``bounds`` gives the shards' columns (``item_bounds``), by default
    ``shard_bounds``, whose widths are whole bytes of ``packed_mask``.
    Returns (values, indices) as ``grouped_topk``."""
    if torch.is_tensor(scores_or_fn):
        n = scores_or_fn.shape[1]
        scores_fn = lambda lo, hi: scores_or_fn[:, lo:hi].contiguous()
    else:
        scores_fn = scores_or_fn
    lo, hi = (bounds or shard_bounds(n, mesh.model))[mesh.model_rank]
    mask = None
    if packed_mask is not None:
        if lo % 8:
            raise ValueError(f"a shard from column {lo} does not start on a byte of the packed mask")
        mask = packed_mask[:, lo // 8 : lo // 8 + -(-(hi - lo) // 8)].contiguous()
    vals, idx = local_topk(scores_fn(lo, hi), k, lo, mask)
    B = vals.shape[0]
    v = all_gather(vals[None], mesh, MODEL_AXIS)  # (S, B, k)
    i = all_gather(idx[None], mesh, MODEL_AXIS)
    return merge_topk(v.permute(1, 0, 2).reshape(B, -1), i.permute(1, 0, 2).reshape(B, -1), k)
