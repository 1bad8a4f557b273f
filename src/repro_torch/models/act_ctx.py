"""The mesh context of a forward pass (port of ``repro.models.act_ctx``),
and the per-layer hook that turns sharded parameters into local tensors.

The reference traces one program for the whole mesh and re-anchors the
activations' batch sharding for GSPMD.  The port runs one process per rank
(``torch.distributed``; NCCL on cards, ``gloo`` on the CPU), and each rank
holds only its own batch rows, so ``constrain`` and ``constrain_btd`` have
nothing to re-anchor: they return their input, after checking that its
rows are this rank's share of the global batch the context was given.
With no context installed every helper is the identity, as in the
reference.

Parameters under a mesh are DTensors placed by ``launch.sharding``.
:func:`materialize` is the port's own hook: a layer calls it on its
parameters just before it computes.  Each DTensor is redistributed to
``Replicate`` over the mesh dims the layer needs (an all-gather), and
``to_local`` hands the compute a plain tensor; in the backward its gradient
goes back into the leaf's own placement: ``Partial`` over the data axes
(each rank saw its own rows), so a reduce-scatter.  That is FSDP on the
functional parameter tree, with no ``nn.Module``.  A mesh dim of size 1
moves nothing, so a 1 x 1 mesh adds no copy.  The kernels only ever see
plain local tensors.

Under ``zero3`` every weight is split on dim 0 over ``data`` and
``model``.  Where the batch does not divide every axis, ``model`` carries
no rows and splits products as under ``2d``: :func:`model_views` gathers
each weight of a layer whole and presents it as the ``2d`` rule places it
(:class:`ModelView`), so the blocks keep the same ``model`` shard as under
``2d`` with no further collective.

:func:`local`, :func:`like` and :func:`reduce_logical` let the optimizer
work on each rank's shards in place and still reduce over the logical
tensors (a norm counts each element once, not once per replica).
"""
from __future__ import annotations

import contextlib
import math
from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.launch import sharding as sh
from repro_torch.tree import tree_leaves, tree_map, tree_paths, tree_unflatten

_MESH = None
_DP_AXES = ("pod", "data")
_BATCH: int | None = None
_MODEL = 1
_VIEWS = False


@contextlib.contextmanager
def activation_sharding(mesh, dp_axes=("pod", "data"), batch=None,
                        policy: str = "2d"):
    """Install ``mesh`` (a ``DeviceMesh`` with named dims, ``("data",
    "model")`` or ``("pod", "data", "model")``) for the calls made under
    it.  ``batch``: their global batch, where the caller knows it; the
    rows each rank holds are then checked against it, and expert
    parallelism tests it as the reference tests its global batch.
    ``policy``: the one the parameters are placed by
    (``launch.sharding.param_spec``); under ``zero3`` with ``model`` left
    out of ``dp_axes`` the blocks split their products over ``model`` on
    views of the gathered weights (:func:`model_views`)."""
    global _MESH, _DP_AXES, _BATCH, _MODEL, _VIEWS
    prev = (_MESH, _DP_AXES, _BATCH, _MODEL, _VIEWS)
    _MESH, _DP_AXES, _BATCH = mesh, tuple(dp_axes), batch
    _MODEL = axis_size(mesh, "model") if mesh is not None and "model" in \
        mesh.mesh_dim_names and "model" not in _DP_AXES else 1
    _VIEWS = policy == "zero3" and _MODEL > 1
    try:
        yield
    finally:
        _MESH, _DP_AXES, _BATCH, _MODEL, _VIEWS = prev


@contextlib.contextmanager
def split_batch(n: int):
    """Under it the global batch is the installed one's ``1 / n``: one of
    ``n`` microbatches."""
    global _BATCH
    prev = _BATCH
    if _BATCH is not None:
        _BATCH = _BATCH // n
    try:
        yield
    finally:
        _BATCH = prev


def mesh():
    return _MESH


def model_size() -> int:
    """The size of the installed mesh's ``model`` axis where it splits
    products (``models/tensor_parallel``), else 1: no mesh, no such axis,
    or ``model`` a data-parallel axis (the ``zero3`` policy's batch, where
    the batch divides every axis)."""
    return _MODEL


def axis_size(m, axis: str) -> int:
    """The size of ``m``'s dim named ``axis``."""
    return m.size(m.mesh_dim_names.index(axis))


def dp_axes() -> tuple[str, ...]:
    m = _MESH
    return tuple(a for a in _DP_AXES if a in m.mesh_dim_names) if m else ()


def dp_size() -> int:
    m = _MESH
    if m is None:
        return 1
    return math.prod(axis_size(m, a) for a in dp_axes())


def global_batch(local_rows: int) -> int:
    """The global batch of a call whose rank holds ``local_rows`` rows: the
    installed one, else the rows of every data-parallel rank."""
    return _BATCH if _BATCH is not None else local_rows * dp_size()


def batch_shards(batch: int) -> int:
    """Over how many ranks a global batch of ``batch`` rows is split: every
    data-parallel axis where they divide it, else ``data`` alone, else
    none (``launch.sharding.batch_spec``'s rule, as ``constrain_btd``
    anchors it in the reference)."""
    size = dp_size()
    if size > 1 and batch % size == 0:
        return size
    if "data" in _MESH.mesh_dim_names and \
            batch % axis_size(_MESH, "data") == 0:
        return axis_size(_MESH, "data")
    return 1


def _check_rows(x: torch.Tensor) -> torch.Tensor:
    if _BATCH is not None and x.shape[0] * batch_shards(_BATCH) != _BATCH:
        raise ValueError(f"this rank holds {x.shape[0]} rows of a global "
                         f"batch of {_BATCH}, not its 1/"
                         f"{batch_shards(_BATCH)} share")
    return x


def constrain(x: torch.Tensor, spec) -> torch.Tensor:
    """The identity: a rank's rows are already its own.  Under a mesh,
    where ``spec`` shards the leading dim, the rows are checked."""
    if _MESH is None or not spec or spec[0] is None:
        return x
    return _check_rows(x)


def constrain_btd(x: torch.Tensor) -> torch.Tensor:
    """(B, ...) batch over the dp axes: the identity, the rows checked."""
    if _MESH is None:
        return x
    return _check_rows(x)


# ------------------------------------------------------------- parameters
def _materialized(t, keep: tuple, partial: tuple):
    if isinstance(t, ModelView):
        return t.local(keep, partial)
    if not isinstance(t, DTensor):
        return t
    m = t.device_mesh
    dp = dp_axes()
    to, grad = [], []
    for i, (name, p) in enumerate(zip(m.mesh_dim_names, t.placements)):
        if m.size(i) == 1 or name in keep:
            to.append(p)
            grad.append(p)
        else:
            to.append(Replicate())
            grad.append(Partial() if name in dp or name in partial
                        else Replicate())
    if tuple(to) != tuple(t.placements):
        t = t.redistribute(m, to)
    return t.to_local(grad_placements=grad)


def materialize(tree: Any, keep: tuple = (), partial: tuple = ()) -> Any:
    """``tree`` with each DTensor leaf gathered into a plain local tensor.

    Every mesh dim is gathered except those named in ``keep``, whose
    placement the local tensor keeps (an expert-parallel rank keeps its
    experts' ``model`` shard).  The gradient a rank computes for the local
    tensor is partial over the data-parallel dims and over those named in
    ``partial`` (a weight whose uses are split over ``model``), and the
    same on every rank of the others; the backward reduces it into the
    leaf's own placement.  The identity on plain tensors and without a
    mesh."""
    if _MESH is None:
        return tree
    return tree_map(lambda t: _materialized(t, tuple(keep), tuple(partial)),
                    tree)


class _OnModelRankZero(torch.autograd.Function):
    """The identity; the backward keeps the gradient on model rank 0 and
    zeroes it on the others.  A weight that every model rank uses whole on
    the rows they share gets the same gradient on each of them, and the
    gather behind a :class:`ModelView` sums its gradient over ``model``."""

    @staticmethod
    def forward(ctx, x):
        ctx.keep = _MESH.get_local_rank("model") == 0
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g if ctx.keep else torch.zeros_like(g)


class ModelView:
    """A weight placed by ``zero3`` (dim 0 over ``data`` and ``model``),
    gathered whole, as the blocks read a weight that the ``2d`` rule places:
    ``dim`` is the dim that rule splits over ``model`` (None: none), which
    :func:`model_split_dim` reports.  :meth:`local` is what
    :func:`materialize` hands a block: the rank's ``model`` shard of
    ``whole`` along ``dim`` where the block keeps it, else ``whole``, a
    view either way, with no collective."""
    __slots__ = ("whole", "dim")

    def __init__(self, whole: torch.Tensor, dim: int | None):
        self.whole, self.dim = whole, dim

    def local(self, keep: tuple, partial: tuple) -> torch.Tensor:
        if "model" in keep and self.dim is not None:
            return self.whole.tensor_split(_MODEL, self.dim)[
                _MESH.get_local_rank("model")]
        if "model" in partial or not (torch.is_grad_enabled()
                                      and self.whole.requires_grad):
            return self.whole
        return _OnModelRankZero.apply(self.whole)


def model_views(tree: Any) -> Any:
    """``tree``'s DTensor leaves as :class:`ModelView` s where the installed
    policy is ``zero3`` and ``model`` splits products (it carries no batch
    rows): each gathered whole over every mesh dim (its gradient summed
    over ``model`` too and reduce-scattered back into its own placement)
    and seen as the ``2d`` rule (``launch.sharding.param_spec``) places it,
    so that the blocks split over ``model`` as they do under ``2d``.
    ``tree`` itself elsewhere."""
    if not _VIEWS:
        return tree
    rules = sh.rules_mesh(_MESH)

    def view(path: str, t):
        if not isinstance(t, DTensor):
            return t
        spec = sh.param_spec(path, t, rules, "2d")
        dim = next((d for d, e in enumerate(spec)
                    if e == "model" or isinstance(e, tuple) and "model" in e),
                   None)
        return ModelView(_materialized(t, (), ("model",)), dim)
    return tree_unflatten(tree, [view(path, t) for path, t in
                                 zip(tree_paths(tree), tree_leaves(tree))])


def local(t):
    """A DTensor's local shard (its storage, under ``no_grad``), or ``t``."""
    return t.to_local() if isinstance(t, DTensor) else t


def model_split_dim(t) -> int | None:
    """The dim of DTensor ``t`` that its placement splits over a ``model``
    mesh dim larger than 1 (of a :class:`ModelView`, its ``dim``), or
    None."""
    if isinstance(t, ModelView):
        return t.dim
    if not isinstance(t, DTensor) or "model" not in \
            t.device_mesh.mesh_dim_names:
        return None
    i = t.device_mesh.mesh_dim_names.index("model")
    p = t.placements[i]
    return p.dim if p.is_shard() and t.device_mesh.size(i) > 1 else None


def distribute(full: torch.Tensor, m, placements) -> DTensor:
    """This rank's shard of ``full`` (every rank holds the same logical
    tensor) as a DTensor over ``m`` with ``placements``; a shard smaller
    than ``full`` is copied out of it, a whole one is ``full`` itself.
    Sharded dims must divide evenly (the sharding rules shard no other)."""
    coord = m.get_coordinate()
    shard = full
    for i, p in enumerate(placements):
        if p.is_shard():
            n = m.size(i)
            if shard.shape[p.dim] % n:
                raise ValueError(f"dim {p.dim} of a {tuple(full.shape)} "
                                 f"tensor does not split over {n} ranks")
            shard = shard.tensor_split(n, p.dim)[coord[i]]
    if shard.numel() != full.numel():
        shard = shard.clone(memory_format=torch.contiguous_format)
    stride = torch.empty(full.shape, device="meta").stride()
    return DTensor.from_local(shard, m, placements, run_check=False,
                              shape=full.shape, stride=stride)


def like(t, shard: torch.Tensor):
    """``shard`` as the local shard of a DTensor placed as ``t`` is, or
    ``shard`` itself where ``t`` is a plain tensor."""
    if not isinstance(t, DTensor):
        return shard
    return DTensor.from_local(shard, t.device_mesh, t.placements,
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def placed_like(g, t):
    """A gradient ``g`` in its parameter ``t``'s placement: a leaf already
    replicated over the data axes needed no gather, so its gradient comes
    back ``Partial`` and is reduced here.  ``g`` itself where it already is
    placed so, or is a plain tensor."""
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(t.placements):
        return g.redistribute(t.device_mesh, t.placements)
    return g


def counts_once(t) -> bool:
    """Whether this rank's shard of ``t`` is the one a logical reduction
    counts: the first replica on every mesh dim ``t`` is replicated over."""
    if not isinstance(t, DTensor):
        return True
    coord = t.device_mesh.get_coordinate()
    return all(c == 0 for c, p in zip(coord, t.placements)
               if p.is_replicate())


def reduce_logical(leaves: list, x: torch.Tensor,
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x``, computed from this rank's shards of ``leaves``, reduced over
    every rank (``op``); ``x`` itself where no leaf is a DTensor."""
    if not any(isinstance(t, DTensor) for t in leaves):
        return x
    dist.all_reduce(x, op=op)
    return x


def mean_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """A per-rank scalar averaged over the ranks of the installed mesh
    (every data-parallel shard of the batch weighs the same)."""
    if _MESH is None:
        return x
    x = x.clone()
    dist.all_reduce(x)
    return x / dist.get_world_size()
