"""Data parallelism, ZeRO-1 and prototype-axis model parallelism on
``torch.distributed``.

Counterpart of the JAX package's ``runtime/mesh.py``.  There one jitted step
over a device mesh *is* the one-device step: GSPMD inserts the collectives,
so every term that couples the rows of a batch stays global.  Here each rank
is a process holding its own rows of the global batch, and the train step
(``train/step.py``) keeps the one-device step's numbers by hand:

* random draws: every rank draws for the whole batch and keeps its rows
  (``BatchShard.local``), so the generators stay in step on every rank;
* the losses: every rank gathers the outputs the losses read
  (``BatchShard.gather``) and computes the global loss.  The gather's
  backward keeps the rank's own rows: every rank computes the same loss,
  so a summing backward would count each row once per rank.  The feature
  losses are instead sums that each rank computes over its own rows and
  the ranks add (``BatchShard.total``, whose backward keeps the rank's
  gradient for the same reason).  A loss term that reads parameters
  directly counts on one rank only (``Mesh.once``);
* BatchNorm: statistics of the global batch through a differentiable
  all-reduce (``BatchShard.all_reduce``);
* gradients: one all-reduce (sum) after the backward
  (``Mesh.all_reduce_grads``); clipping, AdamW and the EMA then run alike
  on every rank.

ZeRO-1 (``state_shardings(..., zero1=True)``) keeps on each rank only its
slice of the Adam moments along the largest dim the data axis divides,
updates that slice of the parameter and all-gathers the parameter.

The model axis of a (``data``, ``model``) mesh splits the head's stacked
prototype axis P (``PROTO_AXIS_PARAMS``, their moments and the (B, H, W,
P) maps): each model rank holds the columns ``Mesh.proto_columns`` gives
it, and the model ranks of one data rank hold the same rows.  The head's
input enters through ``Mesh.to_model`` (its gradient summed over the model
ranks, each of which reads the features for its own columns); the logits
are the ranks' partial products summed (``Mesh.model_sum``, whose backward
is the identity: every rank computes the same loss from the sum); a node
that a column boundary cuts takes its softmax statistics through
``Mesh.model_all_reduce``; the losses read the head's outputs and
parameters gathered whole (``Mesh.gather_columns``, whose backward keeps
the rank's columns).  The backbone stays data-parallel: its gradients and
every other whole leaf's are summed over the data ranks only.

With one rank nothing starts a process group: ``data_mesh()`` in a process
without one returns a mesh of one rank, and the step without a mesh runs.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

Spec = Optional[Tuple[int, str]]     # (dim, mesh axis) a tensor is split on, or None

# how long a collective may wait for the other ranks before it raises
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def init_ranks(world: int, rank: int, device: Union[str, torch.device], *,
               init_method: Optional[str] = None, store: Optional[dist.Store] = None,
               backend: Optional[str] = None,
               timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> None:
    """Join the process group of ``world`` ranks as ``rank``: NCCL for a
    card, gloo for the CPU (``device`` decides; ``backend`` overrides it,
    as gloo on CUDA tensors for two ranks on one card).  Rendezvous through
    ``store`` (a ``FileStore``), or ``init_method`` (``env://`` under
    ``torchrun``, ``tcp://localhost:<port>``)."""
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = dict(backend=backend, world_size=world, rank=rank, timeout=timeout)
    if store is not None:
        kw["store"] = store
    else:
        kw["init_method"] = init_method or "env://"
    dist.init_process_group(**kw)


def close_ranks() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _world() -> Tuple[int, int]:
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


@dataclass(frozen=True, eq=False)
class Mesh:
    """The ranks of one run as a (``data``, ``model``) grid, row-major like
    the JAX mesh's device grid: rank = data_rank * n_model + model_rank.
    ``data_group`` joins the ranks that share a model rank (the batch is
    split over it); ``model_group`` those that share a data rank.  A group
    is None without a process group (the collectives are then skipped), and
    on a 2-D mesh where its axis has one rank."""
    world: int
    rank: int
    device: torch.device
    n_data: int
    n_model: int
    data_group: Optional[dist.ProcessGroup]
    model_group: Optional[dist.ProcessGroup]

    @property
    def data_rank(self) -> int:
        return self.rank // self.n_model

    @property
    def model_rank(self) -> int:
        return self.rank % self.n_model

    # -- collectives over the data axis --------------------------------------
    def all_gather(self, t: torch.Tensor, dim: int = 0, axis: str = "data") -> torch.Tensor:
        """The ``axis`` ranks' ``t`` concatenated along ``dim`` in rank
        order (no gradient)."""
        group, n = ((self.data_group, self.n_data) if axis == "data"
                    else (self.model_group, self.n_model))
        if group is None:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
        return torch.cat(parts, dim=dim)

    def all_reduce_grads(self, params: Mapping[str, torch.nn.Parameter]) -> None:
        """Sum every ``.grad`` over the data ranks, in place, in one
        all-reduce of a flat buffer.  Every rank holds the same set of
        gradients (the graphs are alike).  On a 2-D mesh the sum runs over
        the data ranks only: a head leaf's columns differ between the model
        ranks, and every model rank computes the whole of its other leaves'
        gradients."""
        grads = [p.grad for p in params.values() if p.grad is not None]
        if self.data_group is None or not grads:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.data_group)
        at = 0
        for g in grads:
            g.copy_(flat[at:at + g.numel()].view_as(g))
            at += g.numel()

    def once(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` whose gradient counts on data rank 0 only: for a loss term
        every rank computes alike from parameters (not from its rows),
        whose gradient the all-reduce would otherwise add once a rank.  On
        a 2-D mesh ``t`` is a leaf gathered whole over the model ranks
        (``gather_columns``), whose backward already keeps each model
        rank's columns: the term then counts once across all the ranks."""
        if self.n_data == 1 or not t.requires_grad:
            return t
        return _Once.apply(t, self.data_rank == 0)

    # -- collectives over the model axis -------------------------------------
    def proto_columns(self, num_protos: int) -> Tuple[int, int]:
        """This rank's columns [lo, hi) of the stacked prototype axis of
        ``num_protos`` (padded) slots, an even split over the model ranks;
        raises where the model axis does not divide it."""
        if num_protos % self.n_model:
            raise ValueError(f"the prototype axis of {num_protos} slots does not split "
                             f"evenly over {self.n_model} model ranks")
        k = num_protos // self.n_model
        return self.model_rank * k, (self.model_rank + 1) * k

    def to_model(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the input of this rank's columns: the identity, whose
        gradient is summed over the model ranks (each rank's columns read
        the whole of ``t``)."""
        if self.model_group is None or not t.requires_grad:
            return t
        return _ToModel.apply(t, self)

    def model_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the model ranks of each rank's partial ``t`` (the
        logits' partial products); its gradient is the output's, as every
        rank computes the same loss from the sum."""
        if self.model_group is None:
            return t
        return _Total.apply(t, self.model_group)

    def model_all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` reduced over the model ranks: ``"sum"`` differentiable, the
        gradient of each rank's term the sum of the ranks' gradients (a
        statistic every rank then uses for its own columns); ``"max"``
        without a gradient."""
        if self.model_group is None:
            return t
        if op == "max":
            out = t.detach().clone()
            dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.model_group)
            return out
        return _AllReduce.apply(t, self.model_group)

    def gather_columns(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole tensor of every model rank's columns ``t`` along
        ``dim``; differentiable, its gradient this rank's columns of the
        output's (every rank computes the same loss from it)."""
        if self.model_group is None:
            return t
        if t.requires_grad:
            return _GatherColumns.apply(t, self, dim)
        return self.all_gather(t.detach(), dim=dim, axis="model")


class _Once(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t: torch.Tensor, keep: bool) -> torch.Tensor:
        ctx.keep = keep
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return (g if ctx.keep else torch.zeros_like(g)), None


def data_mesh(num: Optional[int] = None, *, device: Union[str, torch.device] = "cuda") -> Mesh:
    """The 1-D ``data`` mesh over ``num`` ranks (all ranks of the process
    group when None; one rank without a process group).  In a process group
    of one rank the collectives still run, through its backend."""
    world, rank = _world()
    num = world if num is None else num
    if num != world:
        raise ValueError(f"a data mesh of {num} ranks needs a process group of {num} "
                         f"ranks, found {world}")
    group = dist.group.WORLD if dist.is_initialized() else None
    return Mesh(world, rank, resolve_device(device), world, 1, group, None)


def dp_mp_mesh(n_data: int, n_model: int, *,
               device: Union[str, torch.device] = "cuda") -> Mesh:
    """The 2-D (``data``, ``model``) mesh over ``n_data * n_model`` ranks.
    Every rank builds every group (``new_group`` is collective)."""
    world, rank = _world()
    need = n_data * n_model
    if world < need:
        raise ValueError(f"need {need} devices for a ({n_data},{n_model}) "
                         f"mesh, found {world}")
    if world > need:
        raise ValueError(f"a ({n_data},{n_model}) mesh takes {need} ranks; the process "
                         f"group has {world}")
    grid = np.arange(need).reshape(n_data, n_model)
    data_group = model_group = None
    for m in range(n_model):
        g = dist.new_group(grid[:, m].tolist()) if n_data > 1 else None
        if rank % n_model == m:
            data_group = g
    for d in range(n_data):
        g = dist.new_group(grid[d].tolist()) if n_model > 1 else None
        if rank // n_model == d:
            model_group = g
    return Mesh(world, rank, resolve_device(device), n_data, n_model, data_group, model_group)


def _rows_of(mesh: Mesh, n: int) -> slice:
    if n % mesh.n_data:
        raise ValueError(f"a batch of {n} rows does not split over {mesh.n_data} data ranks")
    b = n // mesh.n_data
    return slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)


def shard_batch(mesh: Mesh, *arrays):
    """This rank's rows of each global batch in ``arrays`` (numpy arrays
    or tensors, leading axis split evenly over the data ranks)."""
    return tuple(None if a is None else a[_rows_of(mesh, len(a))] for a in arrays)


def replicate(mesh: Mesh, tensors: Union[Mapping[str, torch.Tensor], Sequence[torch.Tensor]]):
    """Broadcast rank 0's ``tensors`` (a dict's values, or a sequence) to
    every rank, in place; returns them."""
    if mesh.world > 1:
        with torch.no_grad():
            for t in (tensors.values() if isinstance(tensors, Mapping) else tensors):
                dist.broadcast(t, src=0)
    return tensors


@dataclass(frozen=True, eq=False)
class BatchShard:
    """How this rank's rows sit in the global batch: ``views`` stacked
    blocks (the two augmented views of a train forward, or one), each the
    rank's contiguous chunk of that block, in data-rank order."""
    mesh: Mesh
    views: int = 2

    def global_rows(self, local_rows: int) -> int:
        return local_rows * self.mesh.n_data

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of ``t``, a tensor over the global batch."""
        v, W = self.views, self.mesh.n_data
        if W == 1:
            return t
        parts = t.reshape(v, W, t.shape[0] // (v * W), *t.shape[1:])
        return parts[:, self.mesh.data_rank].reshape(-1, *t.shape[1:])

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The global batch of this rank's rows ``t``, in the one-process
        row order.  Differentiable: its gradient is the rank's own rows of
        the output's, as every rank computes the same loss from it."""
        if self.mesh.data_group is None:
            return t
        if t.requires_grad:
            return _GatherRows.apply(t, self)
        return self._gather(t)

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        v, W = self.views, self.mesh.n_data
        whole = self.mesh.all_gather(t.detach())                # (W * v * b, ...)
        parts = whole.reshape(W, v, t.shape[0] // v, *t.shape[1:])
        return parts.transpose(0, 1).reshape(-1, *t.shape[1:])

    def total(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the data ranks of each rank's part ``t`` of a sum
        over the global batch.  Its gradient is the output's: every rank
        computes the same loss from the total, and each rank's part reads
        only its own rows."""
        if self.mesh.data_group is None:
            return t
        return _Total.apply(t, self.mesh.data_group)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the data ranks, differentiable (the
        gradient of each rank's term is the sum of the ranks' gradients):
        a statistic of the global batch, such as BatchNorm's."""
        if self.mesh.data_group is None:
            return t
        return _AllReduce.apply(t, self.mesh.data_group)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t: torch.Tensor, shard: BatchShard) -> torch.Tensor:
        ctx.shard = shard
        return shard._gather(t)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return ctx.shard.local(g).contiguous(), None


class _Total(torch.autograd.Function):
    """The sum over ``group`` of each rank's part; the gradient is the
    output's."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, group) -> torch.Tensor:
        out = t.detach().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g, None


class _AllReduce(torch.autograd.Function):
    """The sum over ``group``; the gradient of each rank's term is the sum
    of the ranks' gradients."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = t.detach().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        out = g.contiguous().clone()
        dist.all_reduce(out, group=ctx.group)
        return out, None


class _ToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        ctx.mesh = mesh
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        out = g.contiguous().clone()
        dist.all_reduce(out, group=ctx.mesh.model_group)
        return out, None


class _GatherColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
        ctx.mesh, ctx.dim, ctx.k = mesh, dim, t.shape[dim]
        return mesh.all_gather(t.detach(), dim=dim, axis="model")

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g.narrow(ctx.dim, ctx.mesh.model_rank * ctx.k, ctx.k).contiguous(), None, None


# -- state layouts ------------------------------------------------------------
#
# The stacked prototype axis P (tree/compile.py) is the architecture's
# scaling axis: every tree node adds a prototype bank, so at large
# phylogenies the head parameters, their Adam moments and the (B, H, W, P)
# maps outgrow one device before the backbone does.  A 2-D mesh splits
# exactly those along P over "model".

# head parameter name -> dim carrying the stacked prototype axis (models/heads.py)
PROTO_AXIS_PARAMS = {
    "head.add_on_kernel": 1,    # (D, P)
    "head.add_on_bias": 0,      # (P,)
    "head.cls_weight": 1,       # (C, P)
    "head.proto_presence": 0,   # (P, 2)
}


def _proto_axis_spec(name: str, shape: Sequence[int]) -> Spec:
    dim = PROTO_AXIS_PARAMS.get(name)
    if dim is not None and len(shape) > dim:
        return dim, "model"
    return None


def _zero1_spec(shape: Sequence[int], dp: int) -> Spec:
    """The largest dim of a moment that ``dp`` divides, split over
    "data"; None (replicated) when no dim divides."""
    best_dim, best_size = None, 0
    for d, size in enumerate(shape):
        if size % dp == 0 and size > best_size:
            best_dim, best_size = d, size
    return None if best_dim is None else (best_dim, "data")


def state_shardings(mesh: Mesh, state, zero1: bool = False) -> Dict[str, Dict[str, Spec]]:
    """For each name of ``state.params``, ``opt.mu`` and ``opt.nu`` (keys
    ``params``, ``mu``, ``nu``): the (dim, axis) it is split on, or None.
    On a 1-D data mesh everything is whole; on a (data, model) mesh the
    head's prototype axis is split over "model", in the parameters and
    their moments.  ``zero1`` with more than one data rank also splits the
    moments over "data" (``_zero1_spec``); a head leaf already split on
    "model" keeps that split.  The step counts are always whole."""
    dp = mesh.n_data
    out: Dict[str, Dict[str, Spec]] = {"params": {}, "mu": {}, "nu": {}}
    for name, p in state.params.items():
        shape = tuple(p.shape)
        proto = _proto_axis_spec(name, shape) if mesh.n_model > 1 else None
        out["params"][name] = proto
        moment = proto
        if moment is None and zero1 and dp > 1:
            moment = _zero1_spec(shape, dp)
        out["mu"][name] = out["nu"][name] = moment
    return out


def on_axis(specs: Mapping[str, Mapping[str, Spec]], axis: str) -> Dict[str, Dict[str, Spec]]:
    """``specs`` (``state_shardings``) with only the splits over ``axis``."""
    return {k: {n: s if s is not None and s[1] == axis else None for n, s in part.items()}
            for k, part in specs.items()}


def split_of(mesh: Mesh, t: torch.Tensor, spec: Spec) -> torch.Tensor:
    """This rank's part of a whole tensor ``t`` under ``spec`` (a view)."""
    if spec is None:
        return t
    dim, axis = spec
    n, r = (mesh.n_data, mesh.data_rank) if axis == "data" else (mesh.n_model, mesh.model_rank)
    k = t.shape[dim] // n
    return t.narrow(dim, r * k, k)


def whole_of(mesh: Mesh, t: torch.Tensor, spec: Spec) -> torch.Tensor:
    """The whole tensor of every rank's part ``t`` under ``spec`` (an
    all-gather along its dim over its axis; no gradient)."""
    if spec is None:
        return t
    dim, axis = spec
    return mesh.all_gather(t, dim=dim, axis=axis)


def split_moments(mesh: Mesh, opt, specs: Mapping[str, Mapping[str, Spec]]):
    """``opt`` (an ``AdamState`` of whole moments) with each moment cut to
    this rank's part (copies, so the whole ones can be freed)."""
    return type(opt)(mu={n: split_of(mesh, t, specs["mu"][n]).clone() for n, t in opt.mu.items()},
                     nu={n: split_of(mesh, t, specs["nu"][n]).clone() for n, t in opt.nu.items()},
                     count=dict(opt.count))


def whole_moments(mesh: Mesh, opt, specs: Mapping[str, Mapping[str, Spec]]):
    """``opt`` with each split moment gathered whole (collective: every
    rank calls it)."""
    return type(opt)(mu={n: whole_of(mesh, t, specs["mu"][n]) for n, t in opt.mu.items()},
                     nu={n: whole_of(mesh, t, specs["nu"][n]) for n, t in opt.nu.items()},
                     count=dict(opt.count))

