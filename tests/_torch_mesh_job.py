"""Run by ``tests/test_torch_mesh.py`` in a subprocess:

    PYTHONPATH=src python tests/_torch_mesh_job.py DIR

Four ``gloo`` ranks on a 2 x 2 ("data", "model") mesh (a ``FileStore``
under DIR), then one rank on a 1 x 1 mesh, each on one torch thread.  Reads
DIR/ep_<arch>.npz (the reference's MoE parameters and an input) and
DIR/vocab_<case>.npz (a reference model's parameters and tokens), writes
DIR/mesh_2x2.json and DIR/mesh_1x1.json (rank 0's results),
DIR/ep_<arch>_out.npy (the expert-parallel output, gathered) and
DIR/vocab_<case>_out.npz (that model's logits, loss and gradients on the
mesh).  Imports the port only.

Cases: ``to_placements`` round trips; expert-parallel MoE (values and every
gradient against the single-process ``_apply_moe_xla``); three train steps
of ``make_train_step`` under the mesh against the same steps without one;
prefill and decode steps bound by ``launch.specs.make_step_and_specs`` on
the mesh against the same steps without one (the logits each step
computes, recorded on the way, and its tokens); both under ``zero3`` too,
at a batch of 2 (``model`` splits the products) and of 4 (``model``
carries rows), and the serve steps under it on 1 x 1; the vocabulary split over
``model`` (a reference model's logits, loss and gradients; the greedy
pick's ties); the blocks' tensor parallelism, attention's, the MLP's and
the RG-LRU's; a layer's collectives.
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
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import shard_rows
from repro_torch.configs import ShapeSpec
from repro_torch.launch.mesh import distribute_tree, place
from repro_torch.launch.specs import make_step_and_specs, model_carries_rows
from repro_torch.launch.hlo_analysis import trace_collectives
from repro_torch.launch.sharding import (P, batch_spec, cache_shardings,
                                         opt_shardings, param_shardings,
                                         to_placements)
from repro_torch.launch.train import row_shard
from repro_torch.models import (act_ctx, blocks, decode_step, forward,
                                init_caches, init_params, loss_fn,
                                params_from_jax, prefill, tensor_parallel)
from repro_torch.models.config import MoEConfig
from repro_torch.models import model as model_mod
from repro_torch.models.model import activation_sharding
from repro_torch.serve import step as serve_step
from repro_torch.train import (AdamWConfig, init_opt_state, init_residual,
                               make_train_step)
from repro_torch.train import step as train_step_mod
from repro_torch.tree import tree_leaves, tree_map, tree_paths, tree_unflatten

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
# zero3 on 2 x 2: at a batch of 2 ``model`` carries no rows and splits the
# products; at 4 it carries rows (every axis divides the batch).  Its train
# steps are plain (neither microbatched nor compressed), so the parameters
# meet the no-mesh step's within 1e-5 with no ordering spread to allow for
ZERO3_TRAIN = ("recurrentgemma-9b", "qwen3-moe-235b-a22b")
ZERO3_B = (2, 4)
# MoE under zero3 with rows over model: experts the 4 ranks divide (expert
# parallelism), and experts only data divides (zero3 places them over data
# alone; the dispatch)
ZERO3_EP_EXPERTS = (8, 6)
# case -> (arch, vocab): tied and untied at a vocabulary 2 divides, and
# one it does not, which stays whole
VOCAB_CASES = {"tied": ("recurrentgemma-9b", 512),
               "untied": ("internlm2-1.8b", 512),
               "odd": ("recurrentgemma-9b", 513)}
VOCAB_B, VOCAB_T1 = 4, 17


def _full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def _rows(t: torch.Tensor, mesh, cols: int | None = None) -> torch.Tensor:
    """A tensor whose rows are split over ``data`` (and the same on every
    model rank, or split over ``model`` along dim ``cols``), gathered
    whole."""
    return DTensor.from_local(t.contiguous(), mesh, [
        Shard(0), Replicate() if cols is None else Shard(cols)]
    ).full_tensor()


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


def case_ep_zero3(mesh, experts: int) -> dict:
    """MoE where ``model`` carries rows (``zero3``, a batch of EP_B over the
    2 x 2 ranks, one row each), the parameters placed by the ``zero3``
    rule: ``experts`` 8 split over both axes (expert parallelism), 6 over
    ``data`` alone (the dispatch, every expert gathered).  Values and
    every gradient against the single-process ``_apply_moe_xla`` on the
    same numpy inputs."""
    cfg = dataclasses.replace(
        reduced(get_config("qwen3-moe-235b-a22b")),
        moe=MoEConfig(experts, 2, 64, capacity_factor=8.0))
    rng = np.random.default_rng(experts)
    d, f = cfg.d_model, cfg.moe.d_expert
    arrays = {"router": (d, experts), "wi": (experts, d, f),
              "wg": (experts, d, f), "wo": (experts, f, d)}
    arrays = {k: torch.from_numpy(0.1 * rng.standard_normal(shape).astype(
        np.float32)) for k, shape in arrays.items()}
    x = torch.from_numpy(rng.standard_normal((EP_B, 16, d)).astype(
        np.float32))
    p_sp = tree_map(lambda t: t.clone().requires_grad_(True), arrays)
    x_sp = x.clone().requires_grad_(True)
    y_sp = blocks._apply_moe_xla(p_sp, x_sp, cfg)
    g_sp = torch.autograd.grad(torch.sum(y_sp ** 2),
                               tree_leaves(p_sp) + [x_sp])
    specs = param_shardings(mesh, arrays, "zero3")
    p = tree_map(lambda t: t.detach().requires_grad_(True),
                 place(arrays, specs, mesh))
    i, n = row_shard(batch_spec(mesh, EP_B, 3, "zero3"), mesh)
    x_loc = x.tensor_split(n)[i].clone().requires_grad_(True)
    taken = []
    inner = blocks._apply_moe_shardmap

    def counted(*args):
        taken.append(1)
        return inner(*args)

    blocks._apply_moe_shardmap = counted
    try:
        with activation_sharding(mesh, ("pod", "data", "model"), batch=EP_B,
                                 policy="zero3"):
            y = blocks.apply_moe(p, x_loc, cfg)
    finally:
        blocks._apply_moe_shardmap = inner
    g = torch.autograd.grad(torch.sum(y ** 2), tree_leaves(p) + [x_loc])
    rows = [Shard(0), Shard(0)]
    g = [_full(gi) for gi in g[:-1]] + [
        DTensor.from_local(g[-1], mesh, rows).full_tensor()]
    y = DTensor.from_local(y.detach(), mesh, rows).full_tensor()
    names = tree_paths(p_sp) + ["/x"]
    return {"rows": n, "shardmap_calls": len(taken),
            "experts_spec": repr(specs["wi"]),
            "max_abs": float((y - y_sp.detach()).abs().max()),
            "max_y": float(y_sp.detach().abs().max()),
            "grad_rel_err": {
                name: float((a - b).abs().max() / b.abs().max())
                for name, a, b in zip(names, g, g_sp)}}


class _Gathered(torch.autograd.Function):
    """``tensor_parallel.all_gather`` of ``tp`` ranks' parts in one
    process: each part's whole, and each part's gradient the sum of the
    wholes' gradients in rank order, sliced."""

    @staticmethod
    def forward(ctx, *parts):
        whole = torch.cat(parts, dim=-1)
        return tuple(whole.clone() for _ in parts)

    @staticmethod
    def backward(ctx, *gs):
        total = gs[0]
        for g in gs[1:]:
            total = total + g
        return total.tensor_split(len(gs), dim=-1)


class _PartsNll(torch.autograd.Function):
    """``tensor_parallel.vocab_cross_entropy``'s arithmetic over ``tp``
    ranks' column slices of the logits in one process: the max over the
    parts, the sums of exponentials and the target's logits summed in rank
    order; the backward each part's ``softmax - onehot``."""

    @staticmethod
    def forward(ctx, labels, *parts):
        n = parts[0].shape[-1]
        mx = parts[0].amax(dim=-1)
        for q in parts[1:]:
            mx = torch.maximum(mx, q.amax(dim=-1))
        total, target, saved = None, None, []
        for i, q in enumerate(parts):
            e = torch.exp(q - mx[..., None])
            local = labels.long() - i * n
            own = (local >= 0) & (local < n)
            idx = torch.where(own, local, 0)[..., None]
            t = torch.where(own, torch.gather(q, -1, idx)[..., 0], 0.0)
            total = e.sum(dim=-1) if total is None else total + e.sum(dim=-1)
            target = t if target is None else target + t
            saved.append((e, idx, own))
        ctx.saved = [(e / total[..., None], idx, own)
                     for e, idx, own in saved]
        return torch.log(total) + mx - target

    @staticmethod
    def backward(ctx, g):
        out = []
        for p, idx, own in ctx.saved:
            grad = p.clone()
            grad.scatter_add_(-1, idx, -own[..., None].to(grad.dtype))
            out.append(grad * g[..., None])
        return (None, *out)


@contextlib.contextmanager
def _mesh_order(n: int, tp: int):
    """Under it, the no-mesh train step groups its sums as a mesh of ``n``
    data ranks and ``tp`` model ranks groups them, with the same products:

    * each microbatch's loss is the mean of the losses of its ``n`` blocks
      of rows (``shard_rows``' blocks, one a data rank), each block its own
      forward, so that a weight's gradient is the sum of the blocks' (the
      mesh's reduction over ``data``);
    * each attention, MLP and RG-LRU block is summed over ``tp`` parts in
      rank order, as the model ranks sum theirs: the MLP's hidden units,
      attention's q heads and the RG-LRU's channels in ``tp`` slices, the
      kv heads too where they divide (else every part reads them all), the
      RG-LRU's gates reading every part's conv output, each part's output
      through its rows of ``wo``, and each part's gradient of its input
      summed apart before the parts' are (``tensor_parallel.copy``);
    * each loss chunk's logits are ``tp`` column slices, combined as
      ``tensor_parallel.vocab_cross_entropy`` combines the ranks': the max
      over the slices, the sums of exponentials and the target's logit
      summed over them."""
    attention, mlp = blocks.apply_attention, blocks.apply_mlp
    rglru, chunk_nll = blocks.apply_rglru, model_mod._chunk_nll
    loss = train_step_mod.loss_fn

    def cols(w, i):
        c = w.shape[-1] // tp
        return w[..., i * c:(i + 1) * c]

    def split_rglru(p, x, cfg, ctx):
        assert ctx.mode == "train", ctx.mode
        xs = [x.view_as(x) for _ in range(tp)]
        t, cw = x.shape[1], cfg.conv_width
        convs = []
        for i in range(tp):
            u = blocks.mm(xs[i], cols(p["wx"], i))
            hist = torch.nn.functional.pad(u, (0, 0, cw - 1, 0))
            convs.append(sum(hist[:, j: j + t] * cols(p["conv"], i)[j]
                             for j in range(cw)))
        wholes = _Gathered.apply(*convs)
        out = None
        for i in range(tp):
            gate = torch.nn.functional.gelu(blocks.mm(xs[i], cols(p["wy"], i)),
                                            approximate="tanh")
            ga = torch.sigmoid(blocks.mm(wholes[i], cols(p["wga"], i)))
            gx = torch.sigmoid(blocks.mm(wholes[i], cols(p["wgx"], i)))
            a = torch.exp(-8.0 * torch.nn.functional.softplus(
                cols(p["a_log"], i))[None, None] * ga.float())
            mult = torch.sqrt(torch.clamp(1.0 - a ** 2, min=1e-12))
            hs = blocks.RGLRUScan.apply((gx * convs[i]).float() * mult, a)
            y = blocks.mm(hs.to(x.dtype) * gate, cols(p["wo"].T, i).T)
            out = y if out is None else out + y
        return out, None

    def split_nll(params, cfg, h_c, y_c, w_c):
        assert cfg.logit_scale is None and cfg.final_softcap is None
        un = params["embed"].T if cfg.tie_embeddings else params["unembed"]
        parts = [blocks.mm(h_c.view_as(h_c), cols(un, i)).float()
                 for i in range(tp)]
        return torch.sum(_PartsNll.apply(y_c, *parts) * w_c[None, :])

    def split_mlp(p, x):
        out = None
        for i in range(tp):
            y = mlp({"wi": cols(p["wi"], i), "wg": cols(p["wg"], i),
                     "wo": cols(p["wo"].T, i).T}, x.view_as(x))
            out = y if out is None else out + y
        return out

    def split_attention(p, x, cfg, ctx, **kw):
        h, kv = cfg.n_heads, cfg.n_kv_heads
        assert ctx.mode == "train" and h % tp == 0, (ctx.mode, h)
        nk = kv // tp if kv % tp == 0 else kv
        part = dataclasses.replace(cfg, n_heads=h // tp, n_kv_heads=nk,
                                   head_dim=cfg.hd)
        out = None
        for i in range(tp):
            pi = dict(p, wq=cols(p["wq"], i), wo=cols(p["wo"].T, i).T)
            if nk < kv:
                pi.update(wk=cols(p["wk"], i), wv=cols(p["wv"], i))
            y = attention(pi, x.view_as(x), part, ctx, **kw)[0]
            out = y if out is None else out + y
        return out, None

    def block_loss(params, cfg, tokens, memory=None):
        assert memory is None
        return sum(loss(params, cfg, t) for t in tokens.tensor_split(n)) / n

    blocks.apply_attention, blocks.apply_mlp = split_attention, split_mlp
    blocks.apply_rglru, model_mod._chunk_nll = split_rglru, split_nll
    train_step_mod.loss_fn = block_loss
    try:
        yield
    finally:
        blocks.apply_attention, blocks.apply_mlp = attention, mlp
        blocks.apply_rglru, model_mod._chunk_nll = rglru, chunk_nll
        train_step_mod.loss_fn = loss


def _no_mesh_run(cfg, opt_cfg, kw: dict, params, states: int,
                 order=contextlib.nullcontext):
    """TRAIN_STEPS steps without a mesh from a copy of ``params``, under
    ``order()`` (:func:`_mesh_order`)."""
    p = tree_map(torch.clone, params)
    o = init_opt_state(p)
    if kw.get("compress"):
        o["residual"] = init_residual(p)
    step = make_train_step(cfg, opt_cfg, **kw)
    rng = np.random.default_rng(states)
    with order():
        for _ in range(TRAIN_STEPS):
            toks = rng.integers(2, cfg.vocab, size=(TRAIN_B, TRAIN_T1)
                                ).astype(np.int32)
            p, o, _ = step(p, o, {"tokens": torch.from_numpy(toks)})
    return p


def train_case(mesh, arch: str, kw: dict, policy: str = "2d",
               b: int = TRAIN_B) -> dict:
    """Three steps under the mesh against the same three without one, from
    the same parameters: losses and every parameter and moment.  Where the
    step microbatches or compresses, also the spread of the no-mesh step
    itself between two orderings of the same sums: its own, and the mesh's
    (:func:`_mesh_order`: the rows grouped into the data ranks' products,
    and the attention and MLP products into the model ranks' partial
    sums).  ``policy``: the parameters', moments' and rows' placement; under
    ``zero3`` the rows go over ``model`` too where the batch ``b`` divides
    every axis, as ``launch.specs`` binds a step."""
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
    o_sh = opt_shardings(mesh, opt, policy)
    if compress:
        o_sh["residual"] = param_shardings(mesh, opt["residual"], policy)
    p = place(params, param_shardings(mesh, params, policy), mesh)
    o = place(opt, o_sh, mesh)
    step = make_train_step(cfg, opt_cfg, **kw)
    rows = model_carries_rows(mesh, policy, b)
    dp = ("pod", "data", "model") if rows else ("pod", "data")
    i, n = row_shard(batch_spec(mesh, b, 2, "zero3" if rows else "2d"), mesh)
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
            toks = rng.integers(2, cfg.vocab, size=(b, TRAIN_T1)
                                ).astype(np.int32)
            ref_p, ref_o, want = ref_step(ref_p, ref_o,
                                          {"tokens": torch.from_numpy(toks)})
            mine = shard_rows(b, (i, n), kw.get("microbatches", 1))
            with activation_sharding(mesh, dp, batch=b,
                                     policy=policy):
                p, o, got = step(p, o, {"tokens": torch.from_numpy(
                    toks[mine])})
            losses.append(got["loss"])
            ref_losses.append(want["loss"])
    finally:
        blocks._apply_moe_shardmap = inner
    full = {k: [(_full(a), b) for a, b in zip(tree_leaves(x),
                                              tree_leaves(y))]
            for k, x, y in (("params", p, ref_p), ("m", o["m"], ref_o["m"]),
                            ("v", o["v"], ref_o["v"]))}
    noise = 0.0
    if n > 1 and (kw.get("microbatches", 1) > 1 or compress) and \
            policy == "2d":
        alt_p = _no_mesh_run(cfg, opt_cfg, kw, params_copy, 5, lambda: (
            _mesh_order(n, act_ctx.axis_size(mesh, "model"))))
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


def _serve_run(cfg, params, tokens, caches, mesh, policy: str = "2d"):
    """Prefill then SERVE_STEPS greedy decode steps; returns (the logits of
    each step, its tokens), whole batches.  Without a mesh the steps of
    ``serve.step``; on one, those ``make_step_and_specs`` binds under
    ``policy``, over placed arguments, the logits gathered from the rows
    (from the rows the step computes on: every axis where ``model``
    carries rows)."""
    b = tokens.shape[0]
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
            cfg, ShapeSpec("serve", SERVE_LEN, b, "prefill"), mesh,
            policy=policy)
        dec, _, dec_in, _, _ = make_step_and_specs(
            cfg, ShapeSpec("serve", SERVE_LEN, b, "decode"), mesh,
            policy=policy)
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
                pos = torch.full((b,), SERVE_T + i, dtype=torch.int32)
                if mesh is not None:
                    cur = distribute_tree(cur, dec_in[1], mesh)
                    pos = distribute_tree(pos, dec_in[2], mesh)
                nxt, caches = dec(params, cur, pos, caches)
            toks.append(_full(nxt))
    finally:
        serve_step.prefill = inner["prefill"]
        serve_step.decode_step = inner["decode_step"]
    cols = [x.shape[-1] for x in logits]
    if mesh is not None and model_carries_rows(mesh, policy, b):
        logits = [DTensor.from_local(x.contiguous(), mesh, [Shard(0)] * 2
                                     ).full_tensor() for x in logits]
    elif mesh is not None:
        logits = [_rows(x, mesh, None if x.shape[-1] == cfg.vocab else 1)
                  for x in logits]
    return logits, toks, cols


def serve_case(mesh, arch: str, policy: str = "2d", b: int = SERVE_B
               ) -> dict:
    """Prefill (SERVE_T tokens into caches of SERVE_LEN) and SERVE_STEPS
    decode steps bound on the mesh under ``policy`` against the same steps
    without one, at a batch of ``b``."""
    cfg = reduced(get_config(arch))
    params = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        2, cfg.vocab, size=(b, SERVE_T)).astype(np.int32))

    def caches():
        return init_caches(cfg, b, SERVE_LEN, dtype=torch.float32,
                           device="cpu")

    want_l, want_t, _ = _serve_run(cfg, params, tokens, caches(), None)
    taken = []
    inner = blocks._apply_moe_shardmap

    def counted(*args):
        taken.append(1)
        return inner(*args)

    blocks._apply_moe_shardmap = counted
    try:
        got_l, got_t, got_cols = _serve_run(cfg, params, tokens, caches(),
                                            mesh, policy)
    finally:
        blocks._apply_moe_shardmap = inner
    return {"steps": len(got_l), "logit_cols": got_cols,
            "max_abs_logits": max(float((a - b).abs().max())
                                  for a, b in zip(got_l, want_l)),
            "max_logit": max(float(b.abs().max()) for b in want_l),
            "tokens_equal": all(torch.equal(a, b)
                                for a, b in zip(got_t, want_t)),
            "logits_equal": all(torch.equal(a, b)
                                for a, b in zip(got_l, want_l)),
            "shardmap_calls": len(taken)}


# ------------------------------------------------------------ the vocabulary
def _unflatten(flat: dict) -> dict:
    """``{"a/b/c": array}`` as nested dicts."""
    tree: dict = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


def case_vocab(mesh, d: str, case: str) -> dict:
    """A reference model's parameters (DIR/vocab_<case>.npz, converted by
    ``params_from_jax``) placed on the mesh: the train-mode logits, gathered
    from the ranks' rows and columns, the loss (the mean over every rank's
    rows) and every gradient, whole, written by rank 0 to
    DIR/vocab_<case>_out.npz; the shapes of the vocabulary's local tensors."""
    arch, vocab = VOCAB_CASES[case]
    cfg = reduced(get_config(arch), vocab=vocab)
    arrays = np.load(os.path.join(d, f"vocab_{case}.npz"))
    params = params_from_jax(_unflatten({k[2:]: arrays[k] for k in arrays
                                         if k.startswith("p/")}), cfg, "cpu")
    p = place(params, param_shardings(mesh, params), mesh)
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(p)]
    p = tree_unflatten(p, leaves)
    toks = _my_rows(torch.from_numpy(arrays["tokens"]), mesh)
    with activation_sharding(mesh, batch=VOCAB_B):
        top = model_mod._top_params(p)
        shapes = {k: list(top[k].shape) for k in ("embed", "unembed")
                  if k in top}
        with torch.no_grad():
            logits, _ = forward(p, cfg, toks)
        loss = loss_fn(p, cfg, toks)
        grads = torch.autograd.grad(loss / act_ctx.dp_size(), leaves)
        loss = act_ctx.mean_over_ranks(loss.detach())
    split = logits.shape[-1] != cfg.vocab
    out = {"logits": _rows(logits, mesh, 2 if split else None).numpy(),
           "loss": loss.numpy()}
    for path, g, t in zip(tree_paths(p), grads, leaves):
        out[f"g{path}"] = _full(act_ctx.placed_like(g, t)).numpy()
    if dist.get_rank() == 0:
        np.savez(os.path.join(d, f"vocab_{case}_out.npz"), **out)
    return {"local_shapes": shapes, "logit_cols": logits.shape[-1]}


def case_argmax(mesh) -> dict:
    """``tensor_parallel.argmax`` over rows built to tie across the model
    ranks, against ``torch.argmax`` on the whole rows: a tie between ranks
    (the lower id wins), a tie inside a rank, the larger value on rank 1,
    -0.0 against +0.0, -inf everywhere but one id, and NaNs: the one
    ``0.0 / 0.0`` gives (sign bit set) on rank 1 beside a larger finite
    value on rank 0, a positive NaN, and NaNs on both ranks."""
    v, tp = 8, act_ctx.axis_size(mesh, "model")
    ninf = -float("inf")
    neg_nan = torch.tensor(0.0) / torch.tensor(0.0)
    pos_nan = torch.tensor([0x7FC00000], dtype=torch.int32).view(
        torch.float32)[0]
    assert neg_nan.view(torch.int32) == torch.tensor(0xFFC00000).to(
        torch.int32) and pos_nan != pos_nan
    rows = torch.tensor([
        [0.0, 1.0, 3.0, 0.0, 2.0, 1.0, 3.0, 0.0],
        [1.0, 3.0, 3.0, 0.0, 1.0, 2.0, 0.0, 2.5],
        [0.0, 1.0, 2.0, 0.0, 1.0, 5.0, 0.0, 5.0],
        [ninf, -0.0, ninf, ninf, 0.0, ninf, ninf, ninf],
        [ninf, ninf, ninf, ninf, ninf, ninf, 7.0, ninf],
        [-2.0, -1.0, -3.0, -1.0, -1.0, -4.0, -2.0, -5.0],
        [0.5, 9.0, 2.0, 3.0, 0.5, 1.0, 0.0, 0.0],
        [0.5, 1.0, 2.0, 3.0, 0.5, 1.0, 0.0, 0.0],
        [0.5, 1.0, 2.0, 3.0, 0.5, 1.0, 0.0, 0.0],
        [0.5, 1.0, 2.0, 3.0, 0.5, 1.0, 0.0, 0.0]])
    rows[6, 5] = neg_nan                      # rank 1's; rank 0 holds 9.0
    rows[7, 2] = pos_nan
    rows[8, 6], rows[8, 3] = neg_nan, pos_nan     # both ranks
    rows[9, 7], rows[9, 4] = pos_nan, neg_nan     # rank 1 alone, two
    with activation_sharding(mesh):
        n = v // tp
        lo = tensor_parallel.rank() * n
        got = tensor_parallel.argmax(rows[:, lo: lo + n].contiguous(), lo)
    return {"got": got.tolist(), "want": rows.argmax(dim=-1).tolist()}


# ------------------------------------------------- tensor-parallel blocks
# config name -> (arch, ModelConfig overrides); at model = 2 the reduced
# configs split their heads as the three cases of blocks.attention_heads:
# A 4 / 2 heads (gemma3, qk-norm), B 4 / 1 (recurrentgemma), C 3 / 1 (1.5
# q heads and half a kv head a rank); C6 is arctic's case C at model 4 (6
# / 2 heads: 1.5 q heads and half a kv head a rank), run on the (1, 4)
# mesh of tests/_torch_xlstm_mesh_job.py
BLOCK_CFGS = {"A": ("gemma3-12b", {}),
              "B": ("recurrentgemma-9b", {}),
              "B-cap": ("recurrentgemma-9b", {"attn_softcap": 50.0}),
              "C": ("gemma3-12b", {"n_heads": 3, "n_kv_heads": 1}),
              "C6": ("arctic-480b", {"n_heads": 6, "n_kv_heads": 2}),
              "xA": ("llama-3.2-vision-11b", {}),
              "xB": ("llama-3.2-vision-11b", {"n_kv_heads": 1}),
              "xC": ("llama-3.2-vision-11b", {"n_heads": 3,
                                              "n_kv_heads": 1})}
BLOCK_B, BLOCK_T = 4, 16
# run -> (config, cross, window, ring length, prompt length, decode steps):
# B's ring of 16 splits by length (8 slots a rank), of 15 stays whole; B's
# windowed ring of 8 holds 3 prompt tokens, so rank 1's 4 slots are empty
# for the first decode steps, and wraps at position 8
SERVE_BLOCKS = {"A": ("A", False, None, 16, 12, 3),
                "B": ("B", False, None, 16, 12, 3),
                "B ring": ("B-cap", False, 8, 8, 3, 10),
                "B whole ring": ("B", False, None, 15, 12, 3),
                "C": ("C", False, None, 16, 12, 3),
                "xA": ("xA", True, None, 0, 12, 3),
                "xB": ("xB", True, None, 0, 12, 3),
                "xC": ("xC", True, None, 0, 12, 3)}
TRAIN_BLOCKS = ("A", "B", "C")
# the (1, 4) mesh's runs: arctic's case C over a ring of 16 split by length
# (4 slots a rank), and a windowed ring of 8 that wraps
SERVE_BLOCKS_1X4 = {"C6": ("C6", False, None, 16, 12, 3),
                    "C6 ring": ("C6", False, 8, 8, 3, 10)}
TRAIN_BLOCKS_1X4 = ("C6",)


def serve_spec(run: str) -> tuple:
    """Run ``run``'s entry of SERVE_BLOCKS or SERVE_BLOCKS_1X4."""
    return {**SERVE_BLOCKS, **SERVE_BLOCKS_1X4}[run]


def block_config(name: str, get, reduce):
    """Config ``name`` of BLOCK_CFGS through ``get`` / ``reduce`` (the
    port's ``get_config`` / ``reduced``, or the reference's)."""
    arch, over = BLOCK_CFGS[name]
    return dataclasses.replace(reduce(get(arch)), **over)


def block_inputs(run: str, cfg, steps: int = 0, t: int = BLOCK_T) -> dict:
    """Numpy inputs of a block run, from a seed of its name: the attention
    (or, for run "mlp", the MLP's, for a run "rglru..." the RG-LRU's)
    parameters, the prompt ``x``, one input a decode step ``xd``, and the
    memory of cross-attention."""
    rng = np.random.default_rng(sum(map(ord, run)))
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd

    def w(*shape):
        return rng.normal(0.0, shape[0] ** -0.5, shape).astype(np.float32)

    if run == "mlp":
        p = {"wi": w(d, cfg.d_ff), "wg": w(d, cfg.d_ff), "wo": w(cfg.d_ff, d)}
    elif run.startswith("rglru"):
        wd = int(cfg.rglru_expand * d)
        p = {"wx": w(d, wd), "wy": w(d, wd), "conv": w(cfg.conv_width, wd),
             "a_log": rng.normal(0.5, 0.5, wd).astype(np.float32),
             "wgx": w(wd, wd), "wga": w(wd, wd), "wo": w(wd, d)}
    else:
        p = {"wq": w(d, h * hd), "wk": w(d, kv * hd), "wv": w(d, kv * hd),
             "wo": w(h * hd, d)}
        if cfg.qk_norm:
            p["q_norm"] = rng.normal(0.0, 0.1, hd).astype(np.float32)
            p["k_norm"] = rng.normal(0.0, 0.1, hd).astype(np.float32)
    out = {f"p/{k}": v for k, v in p.items()}
    out["x"] = rng.standard_normal((BLOCK_B, t, d)).astype(np.float32)
    out["xd"] = rng.standard_normal((max(steps, 1), BLOCK_B, 1, d)).astype(
        np.float32)
    if cfg.memory_len:
        out["memory"] = rng.standard_normal(
            (BLOCK_B, cfg.memory_len, d)).astype(np.float32)
    return out


def _block_params(arrays, mesh):
    p = {k[2:]: torch.from_numpy(v) for k, v in arrays.items()
         if k.startswith("p/")}
    if mesh is None:
        return p
    return place(p, param_shardings(mesh, p), mesh)


def _my_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    if mesh is None:
        return t
    i, n = row_shard(batch_spec(mesh, t.shape[0], t.dim()), mesh)
    return t.tensor_split(n)[i].contiguous()


def _whole_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    return t if mesh is None else _rows(t, mesh)


def _serve_block(mesh, run: str) -> dict:
    """Prefill then decode steps of one attention block, on ``mesh`` (its
    parameters and cache placed by the rules) or without one; each step's
    output and the last caches, whole."""
    name, cross, window, length, t, steps = serve_spec(run)
    cfg = block_config(name, get_config, reduced)
    arrays = block_inputs(run, cfg, steps, t)
    p = _block_params(arrays, mesh)
    if cross:
        shape = (BLOCK_B, cfg.memory_len, cfg.n_kv_heads, cfg.hd)
        cache = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    else:
        cache = blocks.init_attention_cache(cfg, BLOCK_B, length,
                                            torch.float32, "cpu")
    memory = torch.from_numpy(arrays["memory"]) if cross else None
    if mesh is not None:
        cache = place(cache, cache_shardings(mesh, cache, BLOCK_B), mesh)
        memory = None if memory is None else _my_rows(memory, mesh)
    out = {}
    with torch.no_grad(), activation_sharding(mesh, batch=BLOCK_B) \
            if mesh is not None else contextlib.nullcontext():
        for i in range(steps + 1):
            x = torch.from_numpy(arrays["x"] if i == 0 else arrays["xd"][i - 1])
            mode = "prefill" if i == 0 else "decode"
            pos = torch.arange(t, dtype=torch.int32)[None].expand(
                BLOCK_B, t) if i == 0 else torch.full(
                (BLOCK_B, 1), t + i - 1, dtype=torch.int32)
            ctx = blocks.Ctx(mode, _my_rows(pos, mesh), memory, cache)
            y, new = blocks.apply_attention(p, _my_rows(x, mesh), cfg, ctx,
                                            window=window, cross=cross)
            cache = new if mesh is None else tree_map(act_ctx.like, cache,
                                                      new)
            out[f"y{i}"] = _whole_rows(y, mesh).numpy()
    for k, v in cache.items():
        out[f"cache/{k}"] = _full(v).numpy()
    if mesh is not None:
        out["split"] = np.array([-1 if act_ctx.model_split_dim(cache[k])
                                 is None else act_ctx.model_split_dim(
                                     cache[k]) for k in sorted(cache)])
    return out


def _train_block(mesh, run: str) -> dict:
    """One block's train-mode forward (``mlp``: the MLP) and every gradient
    of ``sum(y ** 2)``, whole; on a mesh also each gradient's placement as
    the backward hands it over."""
    mlp = run == "mlp"
    cfg = block_config("A" if mlp else run, get_config, reduced)
    arrays = block_inputs(run, cfg)
    p = tree_map(lambda v: v.detach().requires_grad_(True),
                 _block_params(arrays, mesh))
    x = _my_rows(torch.from_numpy(arrays["x"]), mesh).requires_grad_(True)
    with activation_sharding(mesh, batch=BLOCK_B) if mesh is not None \
            else contextlib.nullcontext():
        y = blocks.apply_mlp(p, x) if mlp else blocks.apply_attention(
            p, x, cfg, blocks.Ctx("train"))[0]
    names = list(p)
    g = torch.autograd.grad(torch.sum(y ** 2), [p[k] for k in names] + [x])
    out = {"y": _whole_rows(y.detach(), mesh).numpy(),
           "g/x": _whole_rows(g[-1], mesh).numpy()}
    for k, gk in zip(names, g[:-1]):
        if mesh is not None:
            out[f"placed/{k}"] = np.array(
                [repr(gk.placements) == repr(p[k].placements)])
            out[f"gpl/{k}"] = np.array([repr(gk.placements)])
            gk = act_ctx.placed_like(gk, p[k])
        out[f"g/{k}"] = _full(gk).numpy()
    return out


RGLRU_T, RGLRU_STEPS = 12, 3


def _rglru_cache(cfg, mesh):
    cache = blocks.init_rglru_cache(cfg, BLOCK_B, torch.float32, "cpu")
    if mesh is None:
        return cache
    return place(cache, cache_shardings(mesh, cache, BLOCK_B), mesh)


def _serve_rglru(mesh) -> dict:
    """The RG-LRU block (recurrentgemma reduced, config "B") at prefill
    then RGLRU_STEPS decode steps, on ``mesh`` (its parameters and states
    placed by the rules) or without one; each output and the last states,
    whole, and on a mesh each state's dim over ``model``."""
    cfg = block_config("B", get_config, reduced)
    arrays = block_inputs("rglru", cfg, RGLRU_STEPS, RGLRU_T)
    p = _block_params(arrays, mesh)
    cache = _rglru_cache(cfg, mesh)
    out = {}
    with torch.no_grad(), activation_sharding(mesh, batch=BLOCK_B) \
            if mesh is not None else contextlib.nullcontext():
        for i in range(RGLRU_STEPS + 1):
            x = torch.from_numpy(arrays["x"] if i == 0
                                 else arrays["xd"][i - 1])
            ctx = blocks.Ctx("prefill" if i == 0 else "decode", None, None,
                             cache)
            y, new = blocks.apply_rglru(p, _my_rows(x, mesh), cfg, ctx)
            cache = new if mesh is None else tree_map(act_ctx.like, cache,
                                                      new)
            out[f"y{i}"] = _whole_rows(y, mesh).numpy()
    for k, v in cache.items():
        out[f"cache/{k}"] = _full(v).numpy()
    if mesh is not None:
        out["split"] = np.array([act_ctx.model_split_dim(cache[k])
                                 for k in sorted(cache)])
    return out


def _train_rglru(mesh) -> dict:
    """The RG-LRU block's train-mode forward and every gradient of
    ``sum(y ** 2)``, whole, as :func:`_train_block`."""
    cfg = block_config("B", get_config, reduced)
    arrays = block_inputs("rglru", cfg)
    p = tree_map(lambda v: v.detach().requires_grad_(True),
                 _block_params(arrays, mesh))
    x = _my_rows(torch.from_numpy(arrays["x"]), mesh).requires_grad_(True)
    with activation_sharding(mesh, batch=BLOCK_B) if mesh is not None \
            else contextlib.nullcontext():
        y = blocks.apply_rglru(p, x, cfg, blocks.Ctx("train"))[0]
    names = list(p)
    g = torch.autograd.grad(torch.sum(y ** 2), [p[k] for k in names] + [x])
    out = {"y": _whole_rows(y.detach(), mesh).numpy(),
           "g/x": _whole_rows(g[-1], mesh).numpy()}
    for k, gk in zip(names, g[:-1]):
        if mesh is not None:
            out[f"placed/{k}"] = np.array(
                [repr(gk.placements) == repr(p[k].placements)])
            out[f"gpl/{k}"] = np.array([repr(gk.placements)])
            gk = act_ctx.placed_like(gk, p[k])
        out[f"g/{k}"] = _full(gk).numpy()
    return out


def _mlp_forward(mesh) -> dict:
    """The MLP at a prompt's T and at decode's T = 1, without autograd."""
    cfg = block_config("A", get_config, reduced)
    arrays = block_inputs("mlp", cfg)
    p = _block_params(arrays, mesh)
    out = {}
    with torch.no_grad(), activation_sharding(mesh, batch=BLOCK_B) \
            if mesh is not None else contextlib.nullcontext():
        for k in ("x", "xd"):
            x = torch.from_numpy(arrays[k] if k == "x" else arrays[k][0])
            out[k] = _whole_rows(blocks.apply_mlp(p, _my_rows(x, mesh)),
                                 mesh).numpy()
    return out


def attention_runs(serve: dict, train: tuple) -> dict:
    """Run name -> fn(mesh or None) for attention's serve runs ``serve``
    (a SERVE_BLOCKS-like table) and train runs ``train``."""
    return {**{f"serve {r}": (lambda r=r: (lambda m: _serve_block(m, r)))()
               for r in serve},
            **{f"train {r}": (lambda r=r: (lambda m: _train_block(m, r)))()
               for r in train}}


def save_runs(mesh, d: str, runs: dict, prefix: str = "block") -> list:
    """Each run of ``runs`` on the mesh and in one process, written to
    DIR/<prefix>_<run>.npz (``mesh/...`` and ``port/...``) by rank 0;
    returns the runs' names."""
    for run, fn in runs.items():
        got, want = fn(mesh), fn(None)
        if dist.get_rank() == 0:
            np.savez(os.path.join(d, f"{prefix}_{run}.npz"),
                     **{f"mesh/{k}": v for k, v in got.items()},
                     **{f"port/{k}": v for k, v in want.items()})
    return sorted(runs)


def case_blocks(mesh, d: str) -> dict:
    """Every block run on the mesh and in one process, written to
    DIR/block_<run>.npz (``mesh/...`` and ``port/...``) by rank 0."""
    runs = {**attention_runs(SERVE_BLOCKS, TRAIN_BLOCKS + ("mlp",)),
            "mlp": _mlp_forward, "serve rglru": _serve_rglru,
            "train rglru": _train_rglru}
    return {"runs": save_runs(mesh, d, runs),
            "plain_caches": _plain_caches(mesh),
            "plain_rglru_caches": _plain_rglru_caches(mesh)}


def _plain_rglru_caches(mesh) -> str:
    """What the RG-LRU says when it is handed its states' local shards (its
    channels) instead of the placed states: the error's text, or ""."""
    cfg = block_config("B", get_config, reduced)
    p = _block_params(block_inputs("rglru", cfg, 1, RGLRU_T), mesh)
    cache = tree_map(act_ctx.local, _rglru_cache(cfg, mesh))
    with torch.no_grad(), activation_sharding(mesh, batch=BLOCK_B):
        try:
            blocks.apply_rglru(
                p, _my_rows(torch.zeros(BLOCK_B, 1, cfg.d_model), mesh), cfg,
                blocks.Ctx("decode", None, None, cache))
        except ValueError as e:
            return str(e)
    return ""


def _plain_caches(mesh) -> str:
    """What attention says when it is handed its ring's local shards (case
    B, a ring split by length) instead of the placed cache: the error's
    text, or "" where it computes."""
    name, _, window, length, t, _ = SERVE_BLOCKS["B"]
    cfg = block_config(name, get_config, reduced)
    p = _block_params(block_inputs("B", cfg, 1, t), mesh)
    cache = blocks.init_attention_cache(cfg, BLOCK_B, length, torch.float32,
                                        "cpu")
    cache = place(cache, cache_shardings(mesh, cache, BLOCK_B), mesh)
    pos = torch.full((BLOCK_B, 1), t, dtype=torch.int32)
    with torch.no_grad(), activation_sharding(mesh, batch=BLOCK_B):
        try:
            blocks.apply_attention(
                p, _my_rows(torch.zeros(BLOCK_B, 1, cfg.d_model), mesh), cfg,
                blocks.Ctx("decode", _my_rows(pos, mesh), None,
                           tree_map(act_ctx.local, cache)), window=window)
        except ValueError as e:
            return str(e)
    return ""


# layer -> (arch, stack, unit[, ModelConfig overrides]) of a reduced
# config; "attn C": minicpm-2b's layer at 3 heads, case C at model 2
LAYERS = {"attn": ("internlm2-1.8b", "s0", ("attn",)),
          "rglru": ("recurrentgemma-9b", "s1", ("rglru",)),
          "xlstm": ("xlstm-350m", "s0", ("mlstm", "mlstm", "mlstm", "slstm")),
          "attn C": ("minicpm-2b", "s0", ("attn",),
                     {"n_heads": 3, "n_kv_heads": 3})}


def layer_config(layer: str, get, reduce):
    """Layer ``layer``'s config through ``get`` / ``reduce``."""
    arch, _, _, *over = LAYERS[layer]
    return dataclasses.replace(reduce(get(arch)), **(over[0] if over else {}))


def case_layer_collectives(mesh, layer: str) -> dict:
    """One reduced layer's forward (prefill, no cache; LAYERS) under
    ``trace_collectives``: its record, and the data gathers of the layer's
    weights, their count and the bytes they return (each weight's
    ``model`` shard, gathered over ``data``)."""
    _, stack, unit, *_ = LAYERS[layer]
    cfg = layer_config(layer, get_config, reduced)
    lp = init_params(cfg, seed=0, dtype=torch.float32,
                     device="cpu")["stacks"][stack][0]
    lp = place(lp, param_shardings(mesh, lp), mesh)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (BLOCK_B, BLOCK_T, cfg.d_model)).astype(np.float32))
    x = _my_rows(x, mesh)
    with torch.no_grad(), activation_sharding(mesh, batch=BLOCK_B):
        _, rec = trace_collectives(
            model_mod._apply_unit, x, unit, lp, None, cfg,
            blocks.Ctx("prefill"))
    sharded = [t for t in tree_leaves(lp) if any(
        pl.is_shard() for pl, n in zip(t.placements, mesh.mesh_dim_names)
        if n == "data")]
    gathers = sum(t.to_local().numel() * 4 * act_ctx.axis_size(mesh, "data")
                  for t in sharded)
    return {"record": rec, "data_gathers": len(sharded),
            "data_gather_bytes": gathers, "rows": x.shape[0], "t": BLOCK_T}


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
            **{f"zero3 ep {e}": (lambda e=e: case_ep_zero3(mesh, e))
               for e in ZERO3_EP_EXPERTS},
            **{f"train {a}": (lambda a=a: train_case(mesh, a,
                                                     TRAIN_CASES[a]))
               for a in TRAIN_CASES},
            **{f"serve {a}": (lambda a=a: serve_case(mesh, a))
               for a in SERVE_ARCHS},
            **{f"zero3 train {a} b{b}": (lambda a=a, b=b: train_case(
                mesh, a, {}, "zero3", b))
               for a in ZERO3_TRAIN for b in ZERO3_B},
            **{f"zero3 serve {a} b{b}": (
                lambda a=a, b=b: serve_case(mesh, a, "zero3", b))
               for a in SERVE_ARCHS for b in ZERO3_B},
            **{f"vocab {c}": (lambda c=c: case_vocab(mesh, d, c))
               for c in VOCAB_CASES},
            "argmax": lambda: case_argmax(mesh),
            "blocks": lambda: case_blocks(mesh, d),
            **{f"{k} layer collectives": (
                lambda k=k: case_layer_collectives(mesh, k)) for k in LAYERS}})
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
               for a in SERVE_ARCHS},
            **{f"zero3 serve {a}": (lambda a=a: serve_case(mesh, a, "zero3"))
               for a in SERVE_ARCHS},
            **{f"{k} layer collectives": (
                lambda k=k: case_layer_collectives(mesh, k)) for k in LAYERS}})
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    out = sys.argv[1]
    mp.spawn(rank_main, args=(4, out), nprocs=4, join=True)
    one_rank(out)
