"""Meshes over the ranks of a ``torch.distributed`` job (port of
``repro.launch.mesh``), and the placement of a tree on one.

The reference builds a ``jax`` mesh over the devices one process sees; the
port runs one process per rank (``torchrun``), so a mesh is a
``DeviceMesh`` over the job's ranks, with the reference's shapes and axis
names.  :func:`init_ranks` joins (or, alone, forms) the job: NCCL for
ranks on CUDA cards, ``gloo`` on the CPU.
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor.placement_types import Placement

from repro_torch.models import act_ctx
from repro_torch.tree import tree_map

from .sharding import to_placements


def init_ranks(device: torch.device) -> tuple[int, int]:
    """Join the job ``torchrun`` started (its environment names the rank,
    the world size and the rendezvous), or form a job of one rank without
    it.  NCCL where ``device`` is a CUDA card (rank r takes the node's card
    ``LOCAL_RANK``), ``gloo`` on the CPU.  Returns (rank, world size)."""
    if not dist.is_initialized():
        cuda = device.type == "cuda"
        kw = {}
        if cuda:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(dev)
            kw["device_id"] = dev
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group("nccl" if cuda else "gloo", **kw)
        else:
            dist.init_process_group("nccl" if cuda else "gloo",
                                    store=dist.HashStore(), rank=0,
                                    world_size=1, **kw)
    return dist.get_rank(), dist.get_world_size()


def _mesh(shape: tuple, axes: tuple):
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False):
    """(16,16) data x model single-pod; (2,16,16) pod x data x model
    multi-pod, over a job of exactly that many ranks.

    The `pod` axis is pure data parallelism: only the gradient all-reduce
    crosses the data-center interconnect; FSDP weight gathers and TP
    collectives stay within a pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs "
                         f"{math.prod(shape)} ranks; the job has {world}")
    return _mesh(shape, axes)


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel axis names for this mesh (pod included if present)."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def make_host_mesh(n_devices: int | None = None, model_parallel: int = 1):
    """A (data, model) mesh over every rank of the job, ``model_parallel``
    ranks to a ``model`` group."""
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"a host mesh spans every rank: n_devices {n}, "
                         f"{world} ranks")
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"model_parallel {model_parallel} does not divide "
                         f"the {n} ranks")
    return _mesh((n // model_parallel, model_parallel), ("data", "model"))


def place(tree, specs, mesh):
    """``tree``'s tensors as DTensors over ``mesh``, each this rank's shard
    of the logical tensor by its spec in ``specs`` (every rank holds the
    same ``tree``).  0-d tensors (the step counter) stay plain: every rank
    computes the same value."""
    return distribute_tree(
        tree, tree_map(lambda spec: to_placements(spec, mesh), specs), mesh)


def distribute_tree(tree, placements, mesh):
    """:func:`place` with each leaf's DTensor placements given (a tree of
    lists, as ``to_placements`` makes them) instead of its spec."""
    def one(t, pl):
        if t.dim() == 0:
            return t
        return act_ctx.distribute(t, mesh, pl)
    return tree_map(one, tree, placements, is_leaf=_is_placements)


def _is_placements(node) -> bool:
    """Whether ``node`` of a placements tree is one leaf's placements."""
    return isinstance(node, list) and bool(node) and all(
        isinstance(p, Placement) for p in node)
