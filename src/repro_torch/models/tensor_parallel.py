"""Tensor parallelism over the mesh's ``model`` axis: the collectives and
the parameter hook that the attention, MLP, MoE, RG-LRU and xLSTM blocks
and the model's vocabulary share.

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
heads or columns only (``wk`` / ``wv`` where the kv heads do not divide but
the q heads do, ``q_norm``, ``k_norm``) is gathered with its gradient
partial over ``model``.

The vocabulary splits as ``param_spec`` places ``embed`` ``(model, data)``
and ``unembed`` ``(data, model)``: a rank holds the rows (columns) of ids
``[lo, lo + V / tp)``.  :func:`vocab_lookup` embeds ids through that shard,
:func:`vocab_cross_entropy` is Megatron's cross entropy over logits split
by columns, and :func:`argmax` is the greedy pick over them; none gathers
a ``(.., V)`` tensor.  :func:`all_gather` joins activations split along a
dim for work that each rank then splits again (the RG-LRU's conv output,
which its dense gates read whole; the mLSTM's ``u``, and its q and k where
a rank holds part of a head; at decode over a ring split by length,
attention's q heads and the ring's positions); :func:`gather` joins them
for work that every rank repeats (the sLSTM's output before its whole
``up`` projection); :func:`reduce_scatter` sums partial outputs into each
rank's share of them (the sLSTM's output gate, whose weight is split by
rows).  :func:`relayout` moves rows between two layouts over ``model``:
recurrent states between the layout their placement gives them and the
one a block computes in (the mLSTM's), and, under autograd, attention's
columns split inside a head to the whole heads a rank touches (case C's
halo).  :func:`to_row_split` turns a split by columns into one by rows
(case C's prefill writing its ring split by length).

Tensor parallelism runs where a mesh is installed whose ``model`` axis is
larger than 1 and is not a data-parallel axis (the ``zero3`` policy spends
it on the batch where the batch divides every axis; elsewhere its weights
reach the blocks as ``act_ctx.model_views`` of the ``2d`` placements).
Otherwise :func:`size` is 1 and the blocks compute as they did without
it: a 1 x 1 mesh adds no collective and no copy.
"""
from __future__ import annotations

import functools

import numpy as np
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


def _gathered(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` joined along ``dim`` in rank order."""
    n = dist.get_world_size(group)
    xs = x.movedim(dim, 0).contiguous()
    out = xs.new_empty((n * xs.shape[0], *xs.shape[1:]))
    dist.all_gather_into_tensor(out, xs, group=group)
    return out.movedim(0, dim)


def _scattered(y: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``y`` summed, this rank's slice of the sum along ``dim``."""
    n = dist.get_world_size(group)
    ys = y.movedim(dim, 0).contiguous()
    out = ys.new_empty((ys.shape[0] // n, *ys.shape[1:]))
    dist.reduce_scatter_tensor(out, ys, group=group)
    return out.movedim(0, dim)


class _AllGather(torch.autograd.Function):
    """Every model rank's ``x`` joined along ``dim`` in rank order; the
    backward sums the whole gradient over ``model`` and hands each rank
    its own slice (a reduce-scatter), since each rank uses the whole on
    its own share of the work."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gathered(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _scattered(g, ctx.dim, ctx.group), None, None


def all_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every model rank's ``x`` concatenated along ``dim``, in rank order,
    under autograd (see :class:`_AllGather`)."""
    return _AllGather.apply(x, dim % x.dim(), group())


class _Gather(torch.autograd.Function):
    """Every model rank's ``x`` joined along ``dim`` in rank order, for work
    that every rank then repeats whole: the backward hands each rank its
    own slice of the gradient, which is the same on every rank."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gathered(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        r = dist.get_rank(ctx.group)
        return g.tensor_split(n, ctx.dim)[r].contiguous(), None, None


def gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every model rank's ``x`` concatenated along ``dim``, for work that
    every model rank repeats (see :class:`_Gather`)."""
    return _Gather.apply(x, dim % x.dim(), group())


class _ReduceScatter(torch.autograd.Function):
    """The ranks' partial ``y`` summed over ``model``, each rank keeping its
    own slice along ``dim``; the backward gathers the slices' gradients."""

    @staticmethod
    def forward(ctx, y, dim, group):
        ctx.dim, ctx.group = dim, group
        return _scattered(y, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gathered(g, ctx.dim, ctx.group), None, None


def reduce_scatter(y: torch.Tensor, dim: int) -> torch.Tensor:
    """``y`` summed over ``model``, this rank's slice of the sum along
    ``dim`` (see :class:`_ReduceScatter`)."""
    return _ReduceScatter.apply(y, dim % y.dim(), group())


# ------------------------------------------------------------ the vocabulary
def vocab_offset(local: int, vocab: int) -> int | None:
    """Where this rank's share of a vocabulary of ``vocab`` ids begins, when
    it holds ``local`` of them: None where it holds them all (no mesh,
    ``model`` 1, or a vocabulary that ``model`` does not divide, which
    ``param_spec`` leaves whole)."""
    return None if local == vocab else rank() * local


def vocab_lookup(ids: torch.Tensor, table: torch.Tensor, offset: int
                 ) -> torch.Tensor:
    """``embed[ids]`` where this rank holds rows ``[offset, offset + n)`` of
    ``embed`` as ``table``: the ids it owns looked up, the rest zero, then
    the sum over ``model``.  Each id has one owner, so the sum adds zeros
    to its row and the result is the whole table's row exactly."""
    local = ids.long() - offset
    own = (local >= 0) & (local < table.shape[0])
    rows = table[torch.where(own, local, 0)]
    return reduce(torch.where(own[..., None], rows, 0))


class _VocabCrossEntropy(torch.autograd.Function):
    """Megatron's cross entropy over logits split by columns over ``model``:
    the max over every rank's columns (an all-reduce MAX), the sum of
    exponentials over them and the target's logit from its owner (one
    all-reduce SUM of both).  Returns each position's negative log
    likelihood, the same on every model rank.  The backward is the rank's
    columns of ``softmax - onehot``, from the saved softmax."""

    @staticmethod
    def forward(ctx, logits, labels, offset, group):
        mx = logits.amax(dim=-1)
        dist.all_reduce(mx, op=dist.ReduceOp.MAX, group=group)
        e = torch.exp(logits - mx[..., None])
        local = labels.long() - offset
        own = (local >= 0) & (local < logits.shape[-1])
        idx = torch.where(own, local, 0)[..., None]
        target = torch.where(own, torch.gather(logits, -1, idx)[..., 0], 0.0)
        sums = torch.stack([e.sum(dim=-1), target])
        dist.all_reduce(sums, group=group)
        e /= sums[0][..., None]
        ctx.save_for_backward(e, idx, own)
        return torch.log(sums[0]) + mx - sums[1]

    @staticmethod
    def backward(ctx, g):
        p, idx, own = ctx.saved_tensors
        grad = p.clone()
        grad.scatter_add_(-1, idx, -own[..., None].to(grad.dtype))
        return grad * g[..., None], None, None, None


def vocab_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                        offset: int) -> torch.Tensor:
    """``-log_softmax(whole logits)[labels]`` for each position, where this
    rank holds the logits' columns ``[offset, offset + n)`` as ``logits``
    (f32, ``(..., n)``); ``labels`` are global ids."""
    return _VocabCrossEntropy.apply(logits, labels, offset, group())


def argmax(logits: torch.Tensor, offset: int) -> torch.Tensor:
    """``torch.argmax`` over the last dim of logits split by columns over
    ``model``, this rank's ``[offset, offset + n)`` given: the largest value
    and, where ranks tie, the lowest global id, as ``torch.argmax`` takes
    the first of equal maxima.  One all-reduce MAX of a key that orders by
    value, then by the id reversed: the value's f32 bits mapped to an
    integer of the same order in the high 32 bits, ``2^32 - 1 - id`` in the
    low ones.  -0.0 is counted as +0.0, as ``torch.argmax`` compares them
    equal.  A NaN of either sign takes the largest high word, so that the
    lowest id holding one wins, as ``torch.argmax`` takes the first NaN."""
    i = logits.argmax(dim=-1)
    v = torch.gather(logits, -1, i[..., None])[..., 0].float()
    bits = (v + 0.0).view(torch.int32).long()      # + 0.0: -0.0 -> +0.0
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    key = torch.where(v != v, 0x7FFFFFFF, key)
    key = key * 2 ** 32 + (2 ** 32 - 1 - (i + offset))
    dist.all_reduce(key, op=dist.ReduceOp.MAX, group=group())
    return 2 ** 32 - 1 - (key & (2 ** 32 - 1))


# Decode runs without autograd, so this is a plain collective.
def all_reduce(x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over ``model`` (a new tensor)."""
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, op=op, group=group())
    return x


# ------------------------------------------------- states between layouts
# A layout of a state whose rows are (heads, width) flattened head-major:
# for each model rank, in rank order, the (h0, nh, x0, nx) it holds, rows
# [x0, x0 + nx) of each head in [h0, h0 + nh).
def _rows(part: tuple, width: int) -> np.ndarray:
    h0, nh, x0, nx = part
    return (np.arange(h0, h0 + nh)[:, None] * width
            + np.arange(x0, x0 + nx)[None]).reshape(-1)


@functools.lru_cache(maxsize=None)
def _relayout_plan(src: tuple, dst: tuple, width: int, r: int):
    """Rank ``r``'s part of moving rows from layout ``src`` to ``dst``:
    (the local rows it sends, in send order; its send counts by rank; its
    receive counts by rank; where the received rows go; its rows in
    ``dst``; whether no rank sends to another).  A rank takes each row it
    needs from itself where it holds it, else from the lowest rank that
    does."""
    have = [_rows(p, width) for p in src]
    need = [_rows(p, width) for p in dst]
    owner = []
    for j, rows in enumerate(need):
        own = np.where(np.isin(rows, have[j]), j, -1)
        for i, held in enumerate(have):
            own[(own < 0) & np.isin(rows, held)] = i
        if (own < 0).any():
            raise ValueError(f"layout {src} lacks rows that {dst} needs")
        owner.append(own)
    send = [np.searchsorted(have[r], need[j][owner[j] == r])
            for j in range(len(dst))]
    recv = [np.nonzero(owner[r] == i)[0] for i in range(len(src))]
    local = all((own == j).all() for j, own in enumerate(owner))
    return (np.concatenate(send), [len(s) for s in send],
            [len(v) for v in recv], np.concatenate(recv), len(need[r]),
            local)


class _Relayout(torch.autograd.Function):
    """Rows along ``dim`` moved by a plan of :func:`_relayout_plan`; the
    backward is the inverse move, each row's gradients from the ranks that
    took it summed into its owner's row."""

    @staticmethod
    def forward(ctx, x, plan, dim, group):
        send, ins, outs, pos, n, local = plan
        ctx.plan, ctx.dim, ctx.group, ctx.rows = plan, dim, group, x.shape[dim]
        xs = x.movedim(dim, 0)
        send = torch.as_tensor(send, device=x.device)
        if local:
            return xs[send].movedim(0, dim)
        got = xs.new_empty((sum(outs), *xs.shape[1:]))
        dist.all_to_all_single(got, xs[send].contiguous(), outs, ins,
                               group=group)
        out = xs.new_empty((n, *xs.shape[1:]))
        out[torch.as_tensor(pos, device=x.device)] = got
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        send, ins, outs, pos, _, local = ctx.plan
        gs = g.movedim(ctx.dim, 0)
        if not local:
            back = gs.new_empty((sum(ins), *gs.shape[1:]))
            dist.all_to_all_single(
                back, gs[torch.as_tensor(pos, device=g.device)].contiguous(),
                ins, outs, group=ctx.group)
            gs = back
        out = gs.new_zeros((ctx.rows, *gs.shape[1:]))
        out.index_add_(0, torch.as_tensor(send, device=g.device), gs)
        return out.movedim(0, ctx.dim), None, None, None


def relayout(x: torch.Tensor, src: tuple, dst: tuple, width: int,
             dim: int = 1) -> torch.Tensor:
    """``x``, whose rows along ``dim`` are this rank's rows in layout
    ``src`` (see :func:`_rows`), as its rows in layout ``dst``: one
    all-to-all over ``model``, or none where every rank holds the rows it
    needs.  Under autograd (attention's halo of the heads a rank's columns
    touch) the backward moves the gradients back and sums them into each
    row's owner; recurrent states move without it."""
    plan = _relayout_plan(src, dst, width, rank())
    return _Relayout.apply(x, plan, dim % x.dim(), group())


# The ring's k and v move at prefill, without autograd: a plain collective.
def to_row_split(x: torch.Tensor) -> torch.Tensor:
    """``x`` ``(B, S, c)``, this rank's ``c`` columns of all ``S`` rows, as
    ``(B, S / tp, tp * c)``: its ``S / tp`` rows in rank order, every
    rank's columns in rank order.  One all-to-all over ``model``."""
    tp = size()
    b, s, c = x.shape
    parts = x.reshape(b, tp, s // tp, c).transpose(0, 1).contiguous()
    got = torch.empty_like(parts)
    dist.all_to_all_single(got, parts, group=group())
    return got.permute(1, 2, 0, 3).reshape(b, s // tp, tp * c)
