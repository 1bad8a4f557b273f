"""Run by ``tests/test_torch_mesh.py`` in a subprocess:

    PYTHONPATH=src python tests/_torch_mesh_job.py DIR

Four ``gloo`` ranks on a 2 x 2 ("data", "model") mesh (a ``FileStore``
under DIR), then one rank on a 1 x 1 mesh, each on one torch thread.  Reads
DIR/ep_<arch>.npz (the reference's MoE parameters and an input), writes
DIR/mesh_2x2.json and DIR/mesh_1x1.json (rank 0's results) and
DIR/ep_<arch>_out.npy (the expert-parallel output, gathered).  Imports the
port only.

Cases: ``to_placements`` round trips; expert-parallel MoE (values and every
gradient against the single-process ``_apply_moe_xla``); three train steps
of ``make_train_step`` under the mesh against the same steps without one;
prefill and decode steps bound by ``launch.specs.make_step_and_specs`` on
the mesh against the same steps without one (the logits each step
computes, recorded on the way, and its tokens).
"""
import dataclasses
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import shard_rows
from repro_torch.configs import ShapeSpec
from repro_torch.launch.mesh import distribute_tree, place
from repro_torch.launch.specs import make_step_and_specs
from repro_torch.launch.sharding import (P, batch_spec, opt_shardings,
                                         param_shardings, to_placements)
from repro_torch.launch.train import row_shard
from repro_torch.models import (act_ctx, blocks, decode_step, init_caches,
                                init_params, prefill)
from repro_torch.models.config import MoEConfig
from repro_torch.models.model import activation_sharding
from repro_torch.serve import step as serve_step
from repro_torch.train import (AdamWConfig, init_opt_state, init_residual,
                               make_train_step)
from repro_torch.tree import tree_leaves, tree_map, tree_paths

EP_ARCHS = {"qwen3-moe-235b-a22b": False, "arctic-480b": True}
EP_B = 4
PLACEMENT_SPECS = [P(None, None), P("data", None), P(None, "model"),
                   P("data", "model"), P("model", "data"),
                   P(("data", "model"), None), P(None, ("data", "model")),
                   P("model", None, "data")]
TRAIN_CASES = {"internlm2-1.8b": {"microbatches": 2},
               "recurrentgemma-9b": {"compress": True},
               "qwen3-moe-235b-a22b": {}}
TRAIN_B, TRAIN_T1, TRAIN_STEPS = 4, 17, 3
SERVE_ARCHS = ("internlm2-1.8b", "recurrentgemma-9b", "qwen3-moe-235b-a22b")
SERVE_B, SERVE_T, SERVE_LEN, SERVE_STEPS = 4, 12, 16, 3


def _full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def _rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """A tensor whose rows are split over ``data`` (and the same on every
    model rank), gathered whole."""
    return DTensor.from_local(t.contiguous(), mesh,
                              [Shard(0), Replicate()]).full_tensor()


def ep_moe_config(arch: str):
    return dataclasses.replace(
        reduced(get_config(arch)),
        moe=MoEConfig(8, 2, 64, dense_residual=EP_ARCHS[arch],
                      capacity_factor=8.0))


def _ep_params(arrays) -> dict:
    p = {k: torch.from_numpy(arrays[k]) for k in ("router", "wi", "wg",
                                                  "wo")}
    if "dense/wi" in arrays:
        p["dense"] = {k: torch.from_numpy(arrays[f"dense/{k}"])
                      for k in ("wi", "wg", "wo")}
    return p


def case_placements(mesh) -> list:
    """distribute then full_tensor gives the tensor back, and each rank's
    shard is JAX's block for its coordinates (major to minor)."""
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    out = []
    for spec in PLACEMENT_SPECS:
        full = torch.arange(8 * 12 * (2 if len(spec) == 3 else 1),
                            dtype=torch.float32).reshape(
            (8, 12) + ((2,) if len(spec) == 3 else ()))
        dt = act_ctx.distribute(full.clone(), mesh,
                                to_placements(spec, mesh))
        want = full
        for d, entry in enumerate(spec):
            axes = () if entry is None else entry \
                if isinstance(entry, tuple) else (entry,)
            i, n = 0, 1
            for a in axes:
                i, n = i * sizes[a] + coord[a], n * sizes[a]
            want = want.tensor_split(n, d)[i]
        out.append({"spec": repr(spec),
                    "round_trip": bool(torch.equal(dt.full_tensor(), full)),
                    "shard": bool(torch.equal(dt.to_local(), want))})
    return out


def case_ep(mesh, d: str, arch: str) -> dict:
    cfg = ep_moe_config(arch)
    arrays = np.load(os.path.join(d, f"ep_{arch}.npz"))
    x = torch.from_numpy(arrays["x"])
    # one process, the single-device dispatch
    p_sp = tree_map(lambda t: t.clone().requires_grad_(True),
                    _ep_params(arrays))
    x_sp = x.clone().requires_grad_(True)
    y_sp = blocks._apply_moe_xla(p_sp, x_sp, cfg)
    g_sp = torch.autograd.grad(torch.sum(y_sp ** 2),
                               tree_leaves(p_sp) + [x_sp])
    # the mesh: this rank's rows, the parameters placed by the rules
    p = _ep_params(arrays)
    p = tree_map(lambda t: t.detach().requires_grad_(True),
                 place(p, param_shardings(mesh, p), mesh))
    i, n = row_shard(batch_spec(mesh, EP_B, 3), mesh)
    x_loc = x.tensor_split(n)[i].clone().requires_grad_(True)
    taken = []
    inner = blocks._apply_moe_shardmap

    def counted(*args):
        taken.append(1)
        return inner(*args)

    blocks._apply_moe_shardmap = counted
    try:
        with activation_sharding(mesh, batch=EP_B):
            y = blocks.apply_moe(p, x_loc, cfg)
    finally:
        blocks._apply_moe_shardmap = inner
    g = torch.autograd.grad(torch.sum(y ** 2), tree_leaves(p) + [x_loc])
    g = [_full(gi) for gi in g[:-1]] + [_rows(g[-1], mesh)]
    y = _rows(y.detach(), mesh)
    if dist.get_rank() == 0:
        np.save(os.path.join(d, f"ep_{arch}_out.npy"), y.numpy())
    names = tree_paths(p_sp) + ["/x"]
    return {"shardmap_calls": len(taken),
            "max_abs_vs_port_xla": float((y - y_sp.detach()).abs().max()),
            "grad_rel_err": {
                name: float((a - b).abs().max() / b.abs().max())
                for name, a, b in zip(names, g, g_sp)}}


def _no_mesh_run(cfg, opt_cfg, kw: dict, params, states: int):
    """TRAIN_STEPS steps without a mesh from a copy of ``params``."""
    p = tree_map(torch.clone, params)
    o = init_opt_state(p)
    if kw.get("compress"):
        o["residual"] = init_residual(p)
    step = make_train_step(cfg, opt_cfg, **kw)
    rng = np.random.default_rng(states)
    for _ in range(TRAIN_STEPS):
        toks = rng.integers(2, cfg.vocab, size=(TRAIN_B, TRAIN_T1)
                            ).astype(np.int32)
        p, o, _ = step(p, o, {"tokens": torch.from_numpy(toks)})
    return p


def train_case(mesh, arch: str, kw: dict) -> dict:
    """Three steps under the mesh against the same three without one, from
    the same parameters: losses and every parameter and moment.  Where the
    step microbatches or compresses, also the spread of the no-mesh step
    itself between two orderings of the same sums: ``microbatches`` and
    ``microbatches`` times the data-parallel shards (the mesh's grouping of
    rows into per-rank products)."""
    cfg = reduced(get_config(arch))
    compress = kw.get("compress", False)
    opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=10)
    params = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")

    def state(p):
        o = init_opt_state(p)
        if compress:
            o["residual"] = init_residual(p)
        return o

    params_copy = tree_map(torch.clone, params)
    ref_p = tree_map(torch.clone, params)
    ref_o = state(ref_p)
    ref_step = make_train_step(cfg, opt_cfg, **kw)
    opt = state(params)
    o_sh = opt_shardings(mesh, opt)
    if compress:
        o_sh["residual"] = param_shardings(mesh, opt["residual"])
    p = place(params, param_shardings(mesh, params), mesh)
    o = place(opt, o_sh, mesh)
    step = make_train_step(cfg, opt_cfg, **kw)
    i, n = row_shard(batch_spec(mesh, TRAIN_B, 2), mesh)
    taken = []
    inner = blocks._apply_moe_shardmap

    def counted(*args):
        taken.append(1)
        return inner(*args)

    rng = np.random.default_rng(5)
    losses, ref_losses = [], []
    blocks._apply_moe_shardmap = counted
    try:
        for _ in range(TRAIN_STEPS):
            toks = rng.integers(2, cfg.vocab, size=(TRAIN_B, TRAIN_T1)
                                ).astype(np.int32)
            ref_p, ref_o, want = ref_step(ref_p, ref_o,
                                          {"tokens": torch.from_numpy(toks)})
            rows = shard_rows(TRAIN_B, (i, n), kw.get("microbatches", 1))
            with activation_sharding(mesh, batch=TRAIN_B):
                p, o, got = step(p, o, {"tokens": torch.from_numpy(
                    toks[rows])})
            losses.append(got["loss"])
            ref_losses.append(want["loss"])
    finally:
        blocks._apply_moe_shardmap = inner
    full = {k: [(_full(a), b) for a, b in zip(tree_leaves(x),
                                              tree_leaves(y))]
            for k, x, y in (("params", p, ref_p), ("m", o["m"], ref_o["m"]),
                            ("v", o["v"], ref_o["v"]))}
    noise = 0.0
    if n > 1 and (kw.get("microbatches", 1) > 1 or compress):
        alt = dict(kw, microbatches=kw.get("microbatches", 1) * n)
        alt_p = _no_mesh_run(cfg, opt_cfg, alt, params_copy, 5)
        noise = max(float((a - b).abs().max()) for a, b in
                    zip(tree_leaves(alt_p), tree_leaves(ref_p)))
    return {"no_mesh_spread": noise,
            "losses": [float(x) for x in losses],
            "ref_losses": [float(x) for x in ref_losses],
            "max_abs_loss": max(float((a - b).abs()) for a, b in
                                zip(losses, ref_losses)),
            "max_abs": {k: max(float((a - b).abs().max()) for a, b in v)
                        for k, v in full.items()},
            "equal": all(torch.equal(a, b) for a, b in
                         zip(losses, ref_losses))
            and all(torch.equal(a, b) for v in full.values()
                    for a, b in v),
            "params_are_dtensors": all(isinstance(t, DTensor) for t in
                                       tree_leaves(p)),
            "step": int(o["step"]), "shardmap_calls": len(taken)}


def _serve_run(cfg, params, tokens, caches, mesh):
    """Prefill then SERVE_STEPS greedy decode steps; returns (the logits of
    each step, its tokens), whole batches.  Without a mesh the steps of
    ``serve.step``; on one, those ``make_step_and_specs`` binds, over
    placed arguments, the logits gathered from the rows."""
    logits = []
    inner = {"prefill": serve_step.prefill,
             "decode_step": serve_step.decode_step}

    def recording(name):
        def call(*a, **kw):
            out = inner[name](*a, **kw)
            logits.append(out[0][:, -1].detach())
            return out
        return call

    if mesh is None:
        pre = serve_step.make_prefill_step(cfg)
        dec = serve_step.make_decode_step(cfg)
    else:
        pre, _, pre_in, _, _ = make_step_and_specs(
            cfg, ShapeSpec("serve", SERVE_LEN, SERVE_B, "prefill"), mesh)
        dec, _, dec_in, _, _ = make_step_and_specs(
            cfg, ShapeSpec("serve", SERVE_LEN, SERVE_B, "decode"), mesh)
        params = distribute_tree(params, pre_in[0], mesh)
        caches = distribute_tree(caches, pre_in[2], mesh)
        tokens = distribute_tree(tokens, pre_in[1], mesh)
    toks = []
    serve_step.prefill = recording("prefill")
    serve_step.decode_step = recording("decode_step")
    try:
        with torch.no_grad():
            nxt, caches = pre(params, tokens, caches)
            for i in range(SERVE_STEPS):
                full = _full(nxt)
                toks.append(full)
                cur = full[:, None]
                pos = torch.full((SERVE_B,), SERVE_T + i, dtype=torch.int32)
                if mesh is not None:
                    cur = distribute_tree(cur, dec_in[1], mesh)
                    pos = distribute_tree(pos, dec_in[2], mesh)
                nxt, caches = dec(params, cur, pos, caches)
            toks.append(_full(nxt))
    finally:
        serve_step.prefill = inner["prefill"]
        serve_step.decode_step = inner["decode_step"]
    if mesh is not None:
        logits = [_rows(x, mesh) for x in logits]
    return logits, toks


def serve_case(mesh, arch: str) -> dict:
    """Prefill (SERVE_T tokens into caches of SERVE_LEN) and SERVE_STEPS
    decode steps bound on the mesh against the same steps without one."""
    cfg = reduced(get_config(arch))
    params = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        2, cfg.vocab, size=(SERVE_B, SERVE_T)).astype(np.int32))

    def caches():
        return init_caches(cfg, SERVE_B, SERVE_LEN, dtype=torch.float32,
                           device="cpu")

    want_l, want_t = _serve_run(cfg, params, tokens, caches(), None)
    taken = []
    inner = blocks._apply_moe_shardmap

    def counted(*args):
        taken.append(1)
        return inner(*args)

    blocks._apply_moe_shardmap = counted
    try:
        got_l, got_t = _serve_run(cfg, params, tokens, caches(), mesh)
    finally:
        blocks._apply_moe_shardmap = inner
    return {"steps": len(got_l),
            "max_abs_logits": max(float((a - b).abs().max())
                                  for a, b in zip(got_l, want_l)),
            "max_logit": max(float(b.abs().max()) for b in want_l),
            "tokens_equal": all(torch.equal(a, b)
                                for a, b in zip(got_t, want_t)),
            "logits_equal": all(torch.equal(a, b)
                                for a, b in zip(got_l, want_l)),
            "shardmap_calls": len(taken)}


def _run(mesh, d: str, name: str, cases: dict) -> None:
    res = {k: fn() for k, fn in cases.items()}
    if dist.get_rank() == 0:
        with open(os.path.join(d, name), "w") as f:
            json.dump(res, f)


def rank_main(rank: int, world: int, d: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/store",
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        _run(mesh, d, "mesh_2x2.json", {
            "placements": lambda: case_placements(mesh),
            **{f"ep {a}": (lambda a=a: case_ep(mesh, d, a))
               for a in EP_ARCHS},
            **{f"train {a}": (lambda a=a: train_case(mesh, a,
                                                     TRAIN_CASES[a]))
               for a in TRAIN_CASES},
            **{f"serve {a}": (lambda a=a: serve_case(mesh, a))
               for a in SERVE_ARCHS}})
    finally:
        dist.destroy_process_group()


def one_rank(d: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        _run(mesh, d, "mesh_1x1.json", {
            **{f"train {a}": (lambda a=a: train_case(mesh, a,
                                                     TRAIN_CASES[a]))
               for a in TRAIN_CASES},
            **{f"serve {a}": (lambda a=a: serve_case(mesh, a))
               for a in SERVE_ARCHS}})
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    out = sys.argv[1]
    mp.spawn(rank_main, args=(4, out), nprocs=4, join=True)
    one_rank(out)
