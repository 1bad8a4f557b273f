"""Tensor parallelism over the mesh's ``model`` axis: the collectives and
the parameter hook that the attention, MLP and MoE blocks share.

The reference asks GSPMD to split the attention and MLP products by its
``2d`` and ``tp`` rules (``launch.sharding.param_spec``): ``wq`` / ``wk`` /
``wv`` / ``wi`` / ``wg`` column-parallel, ``(data, model)``, and ``wo``
row-parallel, ``(model, data)``.  The port issues those collectives itself,
Megatron's pair of them:

* :func:`copy` enters a split region: the identity forward (every model
  rank holds the same activations), and the backward sums the gradient
  over ``model``, since each rank's covers only its own share of the
  columns (or experts, or heads);
* :func:`reduce` leaves it: the ranks' partial outputs summed over
  ``model``; the backward is the identity, each rank already holding the
  whole output's gradient.

:func:`shards` hands a block its weights with the ``model`` shard kept
where their placements split them (``act_ctx.model_split_dim``; the
placements are ``launch.sharding.param_spec``'s rule), gathered over the
data-parallel axes as ``act_ctx.materialize`` gathers every weight;
their gradients go back into their own placement with a reduce-scatter
over ``data`` only.  A weight a block needs whole but uses on its own
heads only (``wk`` / ``wv`` where the kv heads do not divide, ``q_norm``,
``k_norm``) is gathered with its gradient partial over ``model``.

Tensor parallelism runs where a mesh is installed whose ``model`` axis is
larger than 1 and is not a data-parallel axis (the ``zero3`` policy spends
it on the batch).  Elsewhere :func:`size` is 1 and the blocks compute as
they did without it: a 1 x 1 mesh adds no collective and no copy.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from . import act_ctx

AXIS = "model"


def size() -> int:
    """The ``model`` ranks a block splits its products over (1: none)."""
    return act_ctx.model_size()


def rank() -> int:
    """This rank's coordinate on ``model``."""
    return act_ctx.mesh().get_local_rank(AXIS)


def group():
    return act_ctx.mesh().get_group(AXIS)


def shards(p: dict, keep: tuple = (), partial: tuple = ()) -> dict:
    """``p``'s leaves as local tensors: those named in ``keep`` keep their
    ``model`` shard, those in ``partial`` are gathered whole with their
    gradient summed over ``model``, the rest gathered whole."""
    out = {}
    for name, t in p.items():
        if name in keep:
            out[name] = act_ctx.materialize(t, keep=(AXIS,))
        elif name in partial:
            out[name] = act_ctx.materialize(t, partial=(AXIS,))
        else:
            out[name] = act_ctx.materialize(t)
    return out


class _Copy(torch.autograd.Function):
    """The identity forward; the backward sums the gradient over ``model``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Reduce(torch.autograd.Function):
    """The forward sums over ``model``; the backward is the identity.
    ``torch.distributed.nn``'s all-reduce would sum the gradient again."""

    @staticmethod
    def forward(ctx, y, group):
        y = y.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy(x: torch.Tensor, grp=None) -> torch.Tensor:
    """Enter a region split over ``model`` (see the module docstring)."""
    return _Copy.apply(x, grp if grp is not None else group())


def reduce(y: torch.Tensor, grp=None) -> torch.Tensor:
    """Leave it: the partial outputs summed over ``model``."""
    return _Reduce.apply(y, grp if grp is not None else group())


# ------------------------------------------------- serving-only collectives
# Decode runs without autograd, so these are plain collectives.
def gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every model rank's ``x`` concatenated along ``dim``, in rank order
    (one all-gather over ``model``)."""
    n = size()
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group())
    return out.movedim(0, dim)


def all_reduce(x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over ``model`` (a new tensor)."""
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, op=op, group=group())
    return x
