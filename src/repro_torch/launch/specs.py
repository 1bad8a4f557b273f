"""Meta-device stand-ins for every (arch x shape) dry-run cell (port of
``repro.launch.specs``).

``input_specs`` returns (step_kind, args): every model input of the cell as
a tensor on the ``meta`` device, which has a shape and a type and no
storage.  ``make_step_and_specs`` also binds the step function under
activation sharding on a mesh, with each argument's and output's DTensor
placements (``launch.sharding``'s rules through ``to_placements``) and the
arguments the step consumes (the reference's donated ones).

The port runs one process per rank, so the bound step takes its arguments
placed: parameters, optimizer state and caches as DTensors holding this
rank's shards, and the batch's tensors (tokens, positions, memory) as
DTensors whose local rows are this rank's.  It returns its outputs placed
as the output placements say: the next tokens as a DTensor over the rows,
the caches as DTensors placed as they came, the train step's parameters and
state in place and its metrics as plain scalars.

Under the ``2d`` and ``tp`` policies the attention, MLP, RG-LRU and xLSTM
products and the vocabulary are tensor-parallel over ``model``
(``models/tensor_parallel.py``), and under every policy each cache takes
the ``model`` entries ``cache_spec`` gives it: the attention caches
(``k``, ``v``, ``pos``, and cross-attention's ``k`` and ``v``) their kv
heads, or the ring's (the memory's) length where the heads do not
divide; the RG-LRU's
states (``conv``, ``h``) and the sLSTM's (``c``, ``n``, ``m``) their
channels; the mLSTM's ``C`` every head's value rows, its ``n`` every
head's k entries and its ``m`` its heads where ``model`` divides them.
Attention whose q heads do not divide over ``model`` (minicpm-2b's 36,
arctic's 56 at 16; case C) keeps ``wq`` / ``wk`` / ``wv`` split by columns
inside a head, as GSPMD does, and exchanges the halo of the heads a rank's
columns touch.  The next tokens and decode's positions are placed over the
``2d`` pool's rows under every policy, as the reference places them.

``zero3`` places every weight on dim 0 over ``data`` and ``model`` and the
input batch over every axis that divides it.  Where the batch divides
every axis (:func:`model_carries_rows`), ``model`` carries rows: the
blocks compute unsplit, each cache leaf moves at entry from its placement
to the rank's rows whole and back at exit, and expert parallelism gathers
the model ranks' tokens (``models.blocks._apply_moe_shardmap``).  Where
it does not (every serving cell of the production meshes), the rows go
over ``pod`` and ``data`` as under ``2d``, each layer's weights are
gathered whole and read as the ``2d`` placements
(``act_ctx.model_views``), and the blocks split over ``model`` as under
``2d``.
"""
from __future__ import annotations

import functools
from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.configs import SHAPES, ShapeSpec, get_config
from repro_torch.models import act_ctx, init_caches, init_params
from repro_torch.models.config import ModelConfig
from repro_torch.serve.step import make_decode_step, make_prefill_step
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.step import make_train_step
from repro_torch.tree import tree_map

from . import sharding as sh

META = torch.device("meta")


def param_shapes(cfg: ModelConfig, dtype=torch.bfloat16):
    return init_params(cfg, dtype=dtype, device=META)


def cache_shapes(cfg: ModelConfig, batch: int, cache_len: int):
    return init_caches(cfg, batch, cache_len, device=META)


def _cell(arch: str | ModelConfig, shape: str | ShapeSpec
         ) -> tuple[ModelConfig, ShapeSpec]:
    """A cell's config and shape: by name, or given as they are (a reduced
    config, a shape of one's own)."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    return cfg, SHAPES[shape] if isinstance(shape, str) else shape


def input_specs(arch: str | ModelConfig, shape: str | ShapeSpec
                ) -> tuple[str, dict[str, Any]]:
    """Returns (kind, shapes): every model input for this cell on meta."""
    cfg, s = _cell(arch, shape)
    b, t = s.global_batch, s.seq_len
    mem = (torch.empty((b, cfg.memory_len, cfg.d_model), dtype=torch.bfloat16,
                       device=META) if cfg.memory_len else None)

    def ints(*shape):
        return torch.empty(shape, dtype=torch.int32, device=META)

    if s.kind == "train":
        batch = {"tokens": ints(b, t)}
        if mem is not None:
            batch["memory"] = mem
        return "train", {"batch": batch}
    if s.kind == "prefill":
        out = {"tokens": ints(b, t), "caches": cache_shapes(cfg, b, t)}
        if mem is not None:
            out["memory"] = mem
        return "prefill", out
    # decode: one new token against a cache of seq_len
    return "decode", {"tokens": ints(b, 1), "pos": ints(b),
                      "caches": cache_shapes(cfg, b, t)}


def model_carries_rows(mesh, policy: str, batch: int) -> bool:
    """Whether a step under ``policy`` spends ``model`` on a global batch of
    ``batch`` rows: ``zero3``'s batch spec where ``model`` is larger than 1
    and the batch divides every axis (``launch.sharding.batch_spec``).
    Elsewhere the rows go over ``pod`` and ``data`` as under ``2d`` and
    ``model`` splits the products."""
    m = sh.rules_mesh(mesh)
    return policy == "zero3" and m.shape[sh.TP] > 1 and \
        sh.batch_spec(m, batch, 1, policy)[0] == tuple(m.axis_names)


def _to_rows(t, mesh, spec) -> torch.Tensor:
    """This rank's rows of batch tensor ``t`` (placed over its rows) where
    ``spec`` places them: its local shard where its placement is that, else
    gathered whole and sliced (token ids and positions: a few bytes)."""
    want = sh.to_placements(spec, mesh)
    if not isinstance(t, DTensor) or list(t.placements) == want:
        return act_ctx.local(t)
    return act_ctx.distribute(t.full_tensor(), mesh, want).to_local()


def _rows_in(x: torch.Tensor, dim: int | None, group) -> torch.Tensor:
    """A cache leaf's local shard ``x``, its rows over the data axes and its
    dim ``dim`` over ``model`` (None: whole), as this rank's rows over
    ``model`` too, the leaf whole: one all-to-all over ``model``, or a
    slice of its rows where ``dim`` is None."""
    n = dist.get_world_size(group)
    if dim is None:
        return x.tensor_split(n, 0)[dist.get_rank(group)]
    parts = x.reshape(n, x.shape[0] // n, *x.shape[1:]).contiguous()
    got = torch.empty_like(parts)
    dist.all_to_all_single(got, parts, group=group)
    got = got.movedim(0, dim)
    return got.reshape(*got.shape[:dim], -1, *got.shape[dim + 2:])


def _rows_out(y: torch.Tensor, dim: int | None, group) -> torch.Tensor:
    """:func:`_rows_in` undone: this rank's rows over ``model`` back to its
    data group's rows, split along ``dim`` over ``model`` (None: whole, an
    all-gather of the rows)."""
    n = dist.get_world_size(group)
    if dim is None:
        out = y.new_empty((n * y.shape[0], *y.shape[1:]))
        dist.all_gather_into_tensor(out, y.contiguous(), group=group)
        return out
    parts = y.reshape(*y.shape[:dim], n, y.shape[dim] // n,
                      *y.shape[dim + 1:]).movedim(dim, 0).contiguous()
    got = torch.empty_like(parts)
    dist.all_to_all_single(got, parts, group=group)
    return got.reshape(-1, *got.shape[2:])


def _model_dim(t: DTensor) -> int | None:
    """The dim of ``t`` that its placement splits over ``model``, or None."""
    p = t.placements[t.device_mesh.mesh_dim_names.index(sh.TP)]
    return p.dim if p.is_shard() else None


def _bind(fn, mesh, policy: str, batch: int, row_pl: list,
          data_args: tuple, out_rows: tuple, cache_arg: int | None = None):
    """``fn`` under ``activation_sharding(mesh)``: the arguments at
    ``data_args`` (batch tensors, placed over rows) are handed over as this
    rank's rows, and the outputs at ``out_rows`` come back as DTensors
    placed ``row_pl`` over the rows of a global batch of ``batch``.

    The rows are ``zero3``'s, over every axis, where ``model`` carries
    them (:func:`model_carries_rows`), else ``2d``'s.  In the first case
    the blocks do not split over ``model``, and the caches at
    ``cache_arg`` (the output after the next tokens) move at entry from
    their placement to the rank's rows whole (:func:`_rows_in`) and back
    at exit."""
    rows = "zero3" if model_carries_rows(mesh, policy, batch) else "2d"
    dp_axes = ("pod", "data", "model") if rows == "zero3" else \
        ("pod", "data")
    group = mesh.get_group(sh.TP)

    def placed(o, pl):
        return DTensor.from_local(
            o, mesh, pl, run_check=False, shape=(batch, *o.shape[1:]),
            stride=torch.empty((batch, *o.shape[1:]), device=META).stride())

    @functools.wraps(fn)
    def inner(*args):
        args = [tree_map(lambda t: _to_rows(t, mesh, sh.batch_spec(
                    mesh, t.shape[0], t.dim(), rows)), a)
                if i in data_args else a for i, a in enumerate(args)]
        given = args[cache_arg] if rows == "zero3" and \
            cache_arg is not None else None
        if given is not None:
            args[cache_arg] = tree_map(
                lambda t: _rows_in(t.to_local(), _model_dim(t), group), given)
        with act_ctx.activation_sharding(mesh, dp_axes, batch=batch,
                                         policy=policy):
            out = list(fn(*args))
        for i in out_rows:
            out[i] = placed(out[i], sh.to_placements(
                sh.batch_spec(mesh, batch, 1, rows), mesh))
            if list(out[i].placements) != row_pl:
                out[i] = out[i].redistribute(mesh, row_pl)
        if given is not None:
            out[1] = tree_map(lambda y, t: act_ctx.like(
                t, _rows_out(y, _model_dim(t), group)), out[1], given)
        return tuple(out)
    return inner


def make_step_and_specs(arch: str | ModelConfig, shape: str | ShapeSpec,
                        mesh, *,
                        microbatches: int = 1, donate: bool = True,
                        policy: str = "2d"):
    """Builds (fn, args, in_placements, out_placements, donate_argnums).

    ``args`` are the cell's global arguments on meta; ``mesh=None`` gives
    the step without a mesh and no placements (the global program, traced
    whole).  On a mesh, place ``args`` by ``in_placements``
    (``launch.mesh.distribute_tree``) before calling ``fn``.  policy: see
    ``launch.sharding.param_spec`` ("2d" | "zero3" | "tp").  ``arch`` and
    ``shape`` are names, or a config and a ``ShapeSpec`` (see :func:`_cell`).
    The parameters are bf16, as the reference's ``param_shapes``."""
    cfg, _ = _cell(arch, shape)
    kind, shapes = input_specs(cfg, shape)
    p_shapes = param_shapes(cfg)
    if kind == "train":
        step = make_train_step(cfg, AdamWConfig(), microbatches=microbatches)
        args = (p_shapes, init_opt_state(p_shapes), shapes["batch"])
        donate_argnums = (0, 1) if donate else ()
    elif kind == "prefill":
        step = make_prefill_step(cfg)
        args = [p_shapes, shapes["tokens"], shapes["caches"]]
        if "memory" in shapes:
            args.append(shapes["memory"])
        args = tuple(args)
        donate_argnums = (2,) if donate else ()
    else:
        step = make_decode_step(cfg)
        args = (p_shapes, shapes["tokens"], shapes["pos"], shapes["caches"])
        donate_argnums = (3,) if donate else ()
    if mesh is None:
        return step, args, None, None, donate_argnums

    def pl(spec_tree):
        return tree_map(lambda spec: sh.to_placements(spec, mesh), spec_tree)

    def data_pl(tree, pool=policy):
        return tree_map(lambda t: sh.to_placements(
            sh.batch_spec(mesh, t.shape[0], t.dim(), pool), mesh), tree)

    repl = [Replicate()] * mesh.ndim
    p_pl = pl(sh.param_shardings(mesh, p_shapes, policy))
    b = (shapes["batch"] if kind == "train" else shapes)["tokens"].shape[0]
    # the next tokens and decode's positions: the 2d pool's rows, as the
    # reference places them under every policy
    row_pl = sh.to_placements(sh.batch_spec(mesh, b, 1), mesh)
    if kind == "train":
        opt_pl = pl(sh.opt_shardings(mesh, args[1], policy))
        step = _bind(step, mesh, policy, b, row_pl, data_args=(2,),
                     out_rows=())
        in_pl = (p_pl, opt_pl, data_pl(shapes["batch"]))
        out_pl = (p_pl, opt_pl, {"grad_norm": repl, "lr": repl,
                                 "loss": repl})
        return step, args, in_pl, out_pl, donate_argnums

    c_pl = pl(sh.cache_shardings(mesh, shapes["caches"], b))
    tok_pl = data_pl(shapes["tokens"])
    if kind == "prefill":
        step = _bind(step, mesh, policy, b, row_pl,
                     data_args=(1, 3) if len(args) == 4 else (1,),
                     out_rows=(0,), cache_arg=2)
        in_pl = [p_pl, tok_pl, c_pl]
        if len(args) == 4:
            in_pl.append(data_pl(shapes["memory"]))
        return step, args, tuple(in_pl), (row_pl, c_pl), donate_argnums

    step = _bind(step, mesh, policy, b, row_pl, data_args=(1, 2),
                 out_rows=(0,), cache_arg=3)
    in_pl = (p_pl, tok_pl, data_pl(shapes["pos"], "2d"), c_pl)
    return step, args, in_pl, (row_pl, c_pl), donate_argnums
