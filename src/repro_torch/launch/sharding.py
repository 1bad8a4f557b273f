"""Sharding rules: parameter, optimizer, batch and cache partition specs
(port of ``repro.launch.sharding``), and their DTensor placements.

2D weight sharding (MaxText-style): FSDP over ``data``, tensor parallel
over ``model``, expert parallel (the MoE expert dim) over ``model``;
``pod`` is pure data parallelism.  The rules are the reference's, name and
shape based over the ``init_params`` tree, so every architecture gets
coherent specs without per-arch spec trees.  They are host code and import
no torch: a spec is the port's small :class:`P`, one entry per tensor dim
(``None``, a mesh axis name, or a tuple of names, major to minor), and a
mesh is anything with ``.axis_names`` and ``.shape[axis]`` (a JAX
``AbstractMesh`` has both; :func:`rules_mesh` adapts a torch
``DeviceMesh``, and :class:`MeshShape` is an abstract one with no ranks).
:func:`to_placements` maps a spec onto a ``DeviceMesh``'s dims for
``torch.distributed.tensor``.

The port keeps one dict per layer where the reference stacks a unit's
layers on a leading repeat axis (``models/model.py``), and likewise for
caches, so a stacked leaf's spec here is the reference's without its
leading ``None``, and a cache's batch dim is its first.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

from repro_torch.tree import tree_leaves, tree_paths, tree_unflatten

FSDP, TP = "data", "model"


class P:
    """A partition spec: one entry per tensor dim.  A leaf of the port's
    trees (not a tuple, so that spec trees keep their parameters' shape)."""
    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, P) and self.entries == other.entries

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return f"P({', '.join(map(repr, self.entries))})"


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh as the rules see it: axis names and their sizes."""
    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))


def rules_mesh(mesh):
    """``mesh`` as the rules read it: a ``DeviceMesh`` becomes a
    :class:`MeshShape`; a mesh with ``axis_names`` is taken as it is."""
    if hasattr(mesh, "mesh_dim_names"):
        return MeshShape(tuple(mesh.mesh_dim_names), tuple(mesh.shape))
    return mesh


def _path_names(path) -> list[str]:
    """Dict keys along a key path (``tree.tree_paths``' ``/a/0/b`` or a
    sequence of keys), list indices left out as the reference's
    ``_path_names`` leaves out sequence keys."""
    keys = path.split("/") if isinstance(path, str) else path
    return [k for k in keys if isinstance(k, str) and k
            and not k.isdigit()]


def _divisible(dim: int, mesh, axis: str) -> bool:
    return dim % mesh.shape[axis] == 0


def param_spec(path, leaf, mesh, policy: str = "2d") -> P:
    """Partition spec for one parameter leaf.

    policy="2d"    -- FSDP over `data` x TP over `model` (Megatron-style).
    policy="zero3" -- weights sharded over BOTH axes on dim0, no tensor
                      parallelism; the batch shards over every mesh axis.
    policy="tp"    -- TP over `model` only, weights replicated over `data`
                      (the decode-serving policy; see ``param_shardings``).
    """
    mesh = rules_mesh(mesh)
    name = _path_names(path)[-1]
    body = tuple(leaf.shape)

    if policy == "zero3" and len(body) >= 1:
        axes = tuple(a for a in ("data", "model") if a in mesh.axis_names)
        size = math.prod(mesh.shape[a] for a in axes)
        spec = [None] * len(body)
        if body[0] % size == 0:
            spec[0] = axes
        elif body[0] % mesh.shape["data"] == 0:
            spec[0] = "data"
        elif len(body) > 1 and body[1] % mesh.shape["data"] == 0:
            spec[1] = "data"
        return P(*spec)

    def ok(spec_tail):
        # only shard divisible dims; replace non-divisible entries with None
        fixed = []
        for dim, ax in zip(body, spec_tail):
            if ax is None:
                fixed.append(None)
            elif isinstance(ax, tuple):
                size = math.prod(mesh.shape[a] for a in ax)
                fixed.append(ax if dim % size == 0 else None)
            else:
                fixed.append(ax if _divisible(dim, mesh, ax) else None)
        return P(*fixed)

    if name == "embed":
        return ok((TP, FSDP))
    if name == "unembed":
        return ok((FSDP, TP))
    if len(body) <= 1:
        return P(*((None,) * len(body)))
    # MoE experts: (E, D, F) / (E, F, D) -> EP over model
    if name in ("wi", "wg") and len(body) == 3:
        return ok((TP, FSDP, None))
    if name == "wo" and len(body) == 3:
        return ok((TP, None, FSDP))
    if name == "router":
        return ok((FSDP, None))
    # attention / mlp 2D mats: first proj (D, X) -> (fsdp, tp);
    # output proj back to d_model -> (tp, fsdp)
    if name in ("wq", "wk", "wv", "wi", "wg", "wx", "wy", "up", "wu"):
        return ok((FSDP, TP))
    if name in ("wo", "down"):
        return ok((TP, FSDP))
    # recurrent-family square/gate mats and mlstm internals: FSDP only --
    # their inner width doesn't split cleanly over TP
    return ok((FSDP, None))


def strip_axis(spec: P, axis: str) -> P:
    """``spec`` with mesh axis ``axis`` taken out of every entry."""
    out = []
    for e in spec:
        if e == axis:
            out.append(None)
        elif isinstance(e, tuple):
            kept = tuple(a for a in e if a != axis)
            out.append(kept if kept else None)
        else:
            out.append(e)
    return P(*out)


def _map_with_path(fn, tree: Any) -> Any:
    return tree_unflatten(tree, [fn(path, leaf) for path, leaf in
                                 zip(tree_paths(tree), tree_leaves(tree))])


def param_shardings(mesh, params_shapes: Any, policy: str = "2d") -> Any:
    """A tree of :class:`P`, one per leaf of ``params_shapes`` (anything
    with ``.shape``: tensors, meta tensors)."""
    def pick(path, leaf):
        spec = param_spec(path, leaf, mesh,
                          policy if policy == "zero3" else "2d")
        if policy == "tp":      # weights replicated over `data`: serve policy
            spec = strip_axis(spec, FSDP)
        return spec
    return _map_with_path(pick, params_shapes)


def batch_spec(mesh, batch: int, ndim: int, policy: str = "2d") -> P:
    """Shard the leading batch dim over every data-parallel axis that fits.
    zero3: no tensor axis is reserved, so the batch shards over `model` too."""
    mesh = rules_mesh(mesh)
    pool = ("pod", "data", "model") if policy == "zero3" else ("pod", "data")
    axes = [a for a in pool if a in mesh.axis_names]
    size = math.prod(mesh.shape[a] for a in axes)
    if batch % size == 0 and size > 1:
        return P(tuple(axes), *([None] * (ndim - 1)))
    if "data" in mesh.axis_names and batch % mesh.shape["data"] == 0:
        return P("data", *([None] * (ndim - 1)))
    return P(*([None] * ndim))


def cache_spec(mesh, leaf, batch: int) -> P:
    """KV caches / recurrent states: batch over DP; then kv-heads or cache
    length over TP (sequence-parallel KV for small-batch long-context).
    A port cache leaf is one layer's: its batch dim is its first."""
    mesh = rules_mesh(mesh)
    shape = tuple(leaf.shape)
    assert len(shape) >= 1
    b_idx = 0
    spec = [None] * len(shape)
    axes = [a for a in ("pod", "data") if a in mesh.axis_names]
    dp = math.prod(mesh.shape[a] for a in axes)
    if shape[b_idx] % dp == 0 and dp > 1:
        spec[b_idx] = tuple(axes)
    elif shape[b_idx] % mesh.shape["data"] == 0:
        spec[b_idx] = "data"
    tp = mesh.shape[TP]
    # (B, L, Kv, hd): prefer kv-head sharding, else length (SP)
    if len(shape) == 4:
        if shape[2] % tp == 0:
            spec[2] = TP
        elif shape[1] % tp == 0:
            spec[1] = TP
    elif len(shape) >= 2 and shape[-1] % tp == 0 and spec[b_idx] != TP:
        spec[-1] = TP
    return P(*spec)


def cache_shardings(mesh, caches_shapes: Any, batch: int) -> Any:
    return _map_with_path(lambda _, leaf: cache_spec(mesh, leaf, batch),
                          caches_shapes)


def opt_shardings(mesh, opt_shapes: Any, policy: str = "2d") -> Any:
    """Adam m/v mirror the param sharding; scalars (step) replicated.
    (policy="tp" keeps m/v FSDP-sharded anyway -- optimizer state need not
    be replicated even when weights are.)"""
    def pick(path, leaf):
        names = _path_names(path)
        if names and names[0] in ("m", "v"):
            return param_spec(names[1:], leaf, mesh,
                              policy if policy == "zero3" else "2d")
        return P()
    return _map_with_path(pick, opt_shapes)


def to_placements(spec: Sequence, mesh) -> list:
    """A per-tensor-dim spec as per-mesh-dim DTensor placements over a
    ``DeviceMesh``: ``Shard(d)`` on each mesh dim that tensor dim ``d``
    names, ``Replicate()`` on the others.  A tuple entry such as ``("pod",
    "data")`` shards its dim over both, major to minor, which is JAX's
    order and DTensor's for mesh dims in that order."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) if a in names else -1 for a in axes]
        if -1 in idx or idx != sorted(idx) or any(
                isinstance(out[i], Shard) for i in idx):
            raise ValueError(f"spec {spec!r} does not map onto a mesh with "
                             f"dims {names}")
        for i in idx:
            out[i] = Shard(d)
    return out
