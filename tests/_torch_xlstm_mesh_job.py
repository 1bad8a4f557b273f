"""Run by ``tests/test_torch_xlstm_mesh.py`` in a subprocess:

    PYTHONPATH=src python tests/_torch_xlstm_mesh_job.py DIR

Four ``gloo`` ranks (a ``FileStore`` under DIR), first as a 2 x 2 ("data",
"model") mesh, then as a (data 1, model 4) mesh, then one rank on a 1 x 1
mesh, each on one torch thread.  The xLSTM blocks split over ``model``:
each block run (``BLOCK_RUNS``) on its mesh and in one process, written
by rank 0 to DIR/xblock_<mesh>_<run>.npz (``mesh/...`` and ``port/...``,
the inputs drawn from a seed of the run's name by :func:`block_inputs`);
and reduced xlstm-350m's three train steps and its prefill and decode
steps (``_torch_mesh_job``'s ``train_case`` / ``serve_case``).  On the (1,
4) mesh also attention's case C at arctic's split (``_torch_mesh_job``'s
``SERVE_BLOCKS_1X4`` / ``TRAIN_BLOCKS_1X4``, 1.5 q heads and half a kv
head a rank), written to DIR/block_1x4_<kind> <run>.npz.  Rank 0's other
results go to DIR/xlstm_<mesh>.json.  Imports the port only.
"""
import contextlib
import dataclasses
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import init_device_mesh

import _torch_mesh_job as J
from repro_torch.configs import get_config, reduced
from repro_torch.launch.mesh import place
from repro_torch.launch.sharding import cache_shardings
from repro_torch.models import act_ctx, blocks, tensor_parallel
from repro_torch.models.model import activation_sharding
from repro_torch.tree import tree_map

ARCH = "xlstm-350m"
B, T, STEPS, CHUNK = 4, 21, 3, 8     # T 21 over chunks of 8: three, a pad
# run -> (block, config overrides, mesh): at model 2 the mLSTM's 4 heads
# split 2 a rank; at model 4 its 2 heads split half a head a rank, as
# xlstm-350m's 4 heads over 16; the sLSTM at slstm_proj 2.0 has an up /
# down width (128) that model divides, so those stay split too
BLOCK_RUNS = {"mlstm": ("mlstm", {}, "2x2"),
              "slstm": ("slstm", {}, "2x2"),
              "slstm ffn": ("slstm", {"slstm_proj": 2.0}, "2x2"),
              "mlstm h2": ("mlstm", {"n_heads": 2}, "1x4")}
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}


def block_config(run: str, get, reduce):
    """Run ``run``'s config through ``get`` / ``reduce`` (the port's
    ``get_config`` / ``reduced``, or the reference's): reduced xlstm-350m
    at chunk 8 with the run's overrides."""
    return dataclasses.replace(reduce(get(ARCH)), mlstm_chunk=CHUNK,
                               **BLOCK_RUNS[run][1])


def block_inputs(run: str, cfg) -> dict:
    """Numpy inputs of a block run, from a seed of its name: the block's
    parameters (``p/<name>``, N(0, 1 / fan-in)), the prompt ``x`` and one
    input a decode step ``xd``."""
    rng = np.random.default_rng(sum(map(ord, run)))
    d, h = cfg.d_model, cfg.n_heads

    def w(*shape):
        return rng.normal(0.0, shape[0] ** -0.5, shape).astype(np.float32)

    if BLOCK_RUNS[run][0] == "mlstm":
        wd = int(cfg.mlstm_expand * d)
        p = {"wu": w(d, wd), "wg": w(d, wd), "wq": w(wd, wd),
             "wk": w(wd, wd), "wv": w(wd, wd), "wi": w(wd, h),
             "wf": w(wd, h), "wo": w(wd, d)}
    else:
        f = int(cfg.slstm_proj * d)
        p = {"wz": w(d, d), "wi": w(d, d), "wf": w(d, d), "wo": w(d, d),
             "up": w(d, f), "down": w(f, d)}
    out = {f"p/{k}": v for k, v in p.items()}
    out["x"] = rng.standard_normal((B, T, d)).astype(np.float32)
    out["xd"] = rng.standard_normal((STEPS, B, 1, d)).astype(np.float32)
    return out


def _apply(run: str):
    return blocks.apply_mlstm if BLOCK_RUNS[run][0] == "mlstm" \
        else blocks.apply_slstm


def _states(run: str, cfg, mesh):
    init = blocks.init_mlstm_cache if BLOCK_RUNS[run][0] == "mlstm" \
        else blocks.init_slstm_cache
    cache = init(cfg, B, "cpu")
    if mesh is None:
        return cache
    return place(cache, cache_shardings(mesh, cache, B), mesh)


def _in_mesh(mesh):
    return activation_sharding(mesh, batch=B) if mesh is not None \
        else contextlib.nullcontext()


@contextlib.contextmanager
def _recording_shards(seen: dict):
    """Under it ``tensor_parallel.shards`` records the local shape of each
    weight it hands a block."""
    inner = tensor_parallel.shards

    def shards(p, keep=(), partial=()):
        out = inner(p, keep=keep, partial=partial)
        seen.update({k: list(v.shape) for k, v in out.items()})
        return out

    tensor_parallel.shards = shards
    try:
        yield
    finally:
        tensor_parallel.shards = inner


def serve_block(mesh, run: str) -> tuple[dict, dict]:
    """Prefill then STEPS decode steps of one block, on ``mesh`` (its
    parameters and states placed by the rules) or without one: (each
    step's output and the last states, whole; the states' local shards)."""
    cfg = block_config(run, get_config, reduced)
    arrays = block_inputs(run, cfg)
    p = J._block_params(arrays, mesh)
    cache = _states(run, cfg, mesh)
    out = {}
    with torch.no_grad(), _in_mesh(mesh):
        for i in range(STEPS + 1):
            x = torch.from_numpy(arrays["x"] if i == 0
                                 else arrays["xd"][i - 1])
            ctx = blocks.Ctx("prefill" if i == 0 else "decode", None, None,
                             cache)
            y, new = _apply(run)(p, J._my_rows(x, mesh), cfg, ctx)
            cache = new if mesh is None else tree_map(act_ctx.like, cache,
                                                      new)
            out[f"y{i}"] = J._whole_rows(y, mesh).numpy()
    for k, v in cache.items():
        out[f"cache/{k}"] = J._full(v).numpy()
    return out, cache


def state_shards(mesh, placed: dict, whole: dict) -> dict:
    """Each state's dim over ``model`` (-1: none) and, over every rank, the
    largest gap between the rank's local shard and the slice of the
    one-process state ``whole`` that the shard's placement names."""
    out = {}
    for k, t in placed.items():
        want = act_ctx.distribute(whole[k], mesh, t.placements).to_local()
        got = t.to_local()
        fin = torch.isfinite(want)
        gap = torch.tensor([
            float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0,
            float(want[fin].abs().max()) if fin.any() else 0.0,
            float(not torch.equal(torch.isfinite(got), fin)
                  or not torch.equal(got[~fin], want[~fin]))])
        dist.all_reduce(gap, op=dist.ReduceOp.MAX)
        dim = act_ctx.model_split_dim(t)
        out[k] = {"split": -1 if dim is None else dim,
                  "local_shape": list(got.shape),
                  "max_abs": float(gap[0]), "scale": float(gap[1]),
                  "nonfinite_differ": bool(gap[2])}
    return out


def train_block(mesh, run: str) -> tuple[dict, dict]:
    """One block's train-mode forward and every gradient of ``sum(y **
    2)``, whole; on a mesh also each gradient's placement as the backward
    hands it over, and the local shape of each weight the block computes
    with."""
    cfg = block_config(run, get_config, reduced)
    arrays = block_inputs(run, cfg)
    p = tree_map(lambda v: v.detach().requires_grad_(True),
                 J._block_params(arrays, mesh))
    x = J._my_rows(torch.from_numpy(arrays["x"]),
                   mesh).requires_grad_(True)
    seen: dict = {}
    with _in_mesh(mesh), _recording_shards(seen):
        y = _apply(run)(p, x, cfg, blocks.Ctx("train"))[0]
    names = list(p)
    g = torch.autograd.grad(torch.sum(y ** 2), [p[k] for k in names] + [x])
    out = {"y": J._whole_rows(y.detach(), mesh).numpy(),
           "g/x": J._whole_rows(g[-1], mesh).numpy()}
    for k, gk in zip(names, g[:-1]):
        if mesh is not None:
            out[f"placed/{k}"] = np.array(
                [repr(gk.placements) == repr(p[k].placements)])
            out[f"gpl/{k}"] = np.array([repr(gk.placements)])
            gk = act_ctx.placed_like(gk, p[k])
        out[f"g/{k}"] = J._full(gk).numpy()
    return out, seen


def plain_states(mesh, run: str) -> str:
    """What the block says when it is handed its states' local shards
    instead of the placed states: the error's text, or ""."""
    cfg = block_config(run, get_config, reduced)
    p = J._block_params(block_inputs(run, cfg), mesh)
    cache = tree_map(act_ctx.local, _states(run, cfg, mesh))
    with torch.no_grad(), _in_mesh(mesh):
        try:
            _apply(run)(p, J._my_rows(torch.zeros(B, 1, cfg.d_model), mesh),
                        cfg, blocks.Ctx("decode", None, None, cache))
        except ValueError as e:
            return str(e)
    return ""


def case_blocks(mesh, mesh_name: str, d: str) -> dict:
    """The block runs of ``mesh_name`` on ``mesh`` and in one process,
    written to DIR/xblock_<mesh_name>_<run>.npz by rank 0; returns each
    run's state shards, weight shapes and refusal of plain states."""
    res = {}
    for run, (_, _, where) in BLOCK_RUNS.items():
        if where != mesh_name and mesh_name != "1x1":
            continue
        got, placed = serve_block(mesh, run)
        want, whole = serve_block(None, run)
        tgot, seen = train_block(mesh, run)
        twant, _ = train_block(None, run)
        res[run] = {"shapes": seen, "plain": plain_states(mesh, run)}
        if mesh_name != "1x1":
            res[run]["states"] = state_shards(mesh, placed, whole)
        if dist.get_rank() == 0:
            for kind, a, b in (("serve", got, want), ("train", tgot, twant)):
                np.savez(os.path.join(d, f"xblock_{mesh_name}_{kind} {run}"
                                         f".npz"),
                         **{f"mesh/{k}": v for k, v in a.items()},
                         **{f"port/{k}": v for k, v in b.items()})
    return res


def _run(d: str, mesh, mesh_name: str) -> None:
    res = {"blocks": case_blocks(mesh, mesh_name, d)}
    if mesh_name == "1x4":
        res["attention"] = J.save_runs(mesh, d, J.attention_runs(
            J.SERVE_BLOCKS_1X4, J.TRAIN_BLOCKS_1X4), "block_1x4")
    else:
        res["train"] = J.train_case(mesh, ARCH, {})
        res["serve"] = J.serve_case(mesh, ARCH)
    if dist.get_rank() == 0:
        with open(os.path.join(d, f"xlstm_{mesh_name}.json"), "w") as f:
            json.dump(res, f)


def rank_main(rank: int, world: int, d: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/store",
                            rank=rank, world_size=world)
    try:
        for name, shape in MESHES.items():
            _run(d, init_device_mesh("cpu", shape,
                                     mesh_dim_names=("data", "model")), name)
    finally:
        dist.destroy_process_group()


def one_rank(d: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        _run(d, init_device_mesh("cpu", (1, 1),
                                 mesh_dim_names=("data", "model")), "1x1")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    out = sys.argv[1]
    mp.spawn(rank_main, args=(4, out), nprocs=4, join=True)
    one_rank(out)
