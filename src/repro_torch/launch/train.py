"""The trainer: config-driven, fault-tolerant, resumable (port of
``repro.launch.train``), over a mesh of the job's ranks.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
        --smoke --steps 200 --ckpt-dir /tmp/ckpt --resume [--device cpu]
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --smoke --device cpu [--model-parallel 2]

Its flags, outputs and fault-tolerance contract are the reference's, plus
``--device`` (default ``cuda``, which raises without a card; ``cpu`` for
tests):
  * checkpoints every --ckpt-every steps (async, atomic, crc-verified) +
    final; --resume restarts from the latest DONE checkpoint;
  * the data pipeline is step-addressed, so a resume replays the exact
    sample order;
  * a heartbeat file (step + wallclock) is written every step, and
    ``metrics.jsonl`` every --log-every; --die-at-step N simulates a hard
    failure (exit 42 on every rank) after the last checkpoint has landed;
  * elastic: the mesh is built from the ranks present at startup, and
    checkpoints store logical arrays, so a resume may use another number
    of ranks.
As in the reference, the mesh always spans every rank: ``(world /
model_parallel, model_parallel)`` over ``("data", "model")``.  One process
is a rank (``torchrun`` starts several; alone, a process is a job of one):
NCCL on cards, ``gloo`` on the CPU.  Parameters and AdamW state are
DTensors placed by the sharding rules, each rank takes its rows of every
global batch, and the step runs under ``activation_sharding(mesh)``: a
layer gathers its parameters as it runs, and the ``model`` axis splits the
MoE experts and the attention and MLP products (``models/tensor_parallel``;
the embedding, the unembedding and the recurrent blocks are computed on
every model rank, where GSPMD would split them).  The first rank prints and writes the heartbeat,
the metrics and the checkpoints.  f32 matmuls keep torch's default
precision (no TF32), so ``--dtype float32`` means what it means in the
reference.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import time

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import (DataPipeline, PipelineConfig,
                                       synthetic_corpus)
from repro_torch.index.engine import resolve_device
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import init_ranks, make_host_mesh, place
from repro_torch.models import init_params
from repro_torch.models.model import activation_sharding
from repro_torch.train.compress import init_residual
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.step import make_train_step
from repro_torch.tree import tree_map


def _to_device(tree, like):
    """Restored host leaves onto the device and type of ``like``'s (a
    DTensor comes back from ``restore`` already placed)."""
    return tree_map(lambda t, ref: t if isinstance(t, DTensor) else
                    torch.as_tensor(t).to(device=ref.device,
                                          dtype=ref.dtype), tree, like)


def row_shard(spec, mesh) -> tuple[int, int]:
    """(i, n): this rank holds the i-th of n equal blocks of a batch's rows
    under the batch spec ``spec`` (its leading entry's axes, major to
    minor)."""
    entry = spec[0]
    axes = () if entry is None else entry if isinstance(entry, tuple) \
        else (entry,)
    i, n = 0, 1
    for a in axes:
        size = mesh.size(mesh.mesh_dim_names.index(a))
        i, n = i * size + mesh.get_local_rank(a), n * size
    return i, n


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-size)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--schedule", default="cosine",
                    choices=["cosine", "wsd", "const"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--die-at-step", type=int, default=-1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (this rank's card) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    device = resolve_device(args.device)
    created = not dist.is_initialized()
    rank, _ = init_ranks(device)
    try:
        return _train(args, cfg, resolve_device(args.device), rank)
    finally:
        if created and dist.is_initialized():
            dist.destroy_process_group()


def _train(args, cfg, device, rank: int):
    mesh = make_host_mesh(model_parallel=args.model_parallel)
    dtype = getattr(torch, args.dtype)
    first = rank == 0

    corpus = synthetic_corpus(n_tokens=max(2_000_000,
                                           args.batch * (args.seq + 1) * 50),
                              vocab=cfg.vocab, seed=args.seed)
    pipe = DataPipeline(corpus, PipelineConfig(
        seq_len=args.seq, batch_size=args.batch, seed=args.seed))
    if first:
        print(f"corpus: {corpus.n_tokens} tokens, {corpus.n_docs} docs; "
              f"doc-index: {pipe.doc_index.index_size_bytes()}B at "
              f"error={pipe.doc_index.error} "
              f"(dense table: {corpus.n_docs * 8}B)", flush=True)

    params = init_params(cfg, seed=args.seed, dtype=dtype, device=device)
    opt_cfg = AdamWConfig(lr=args.lr, schedule=args.schedule,
                          warmup_steps=max(2, args.steps // 20),
                          total_steps=args.steps)
    opt_state = init_opt_state(params)
    if args.compress:
        opt_state["residual"] = init_residual(params)
    o_sh = sh.opt_shardings(mesh, opt_state)
    if args.compress:   # residual shards like params
        o_sh["residual"] = sh.param_shardings(mesh, opt_state["residual"])
    params = place(params, sh.param_shardings(mesh, params), mesh)
    opt_state = place(opt_state, o_sh, mesh)
    shard = row_shard(sh.batch_spec(mesh, args.batch, 2), mesh)
    if first:
        print(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))} over "
              f"{dist.get_world_size()} rank(s), {dist.get_backend()}; "
              f"parameters DTensors on {device}", flush=True)

    start_step = 0
    ckpt_dir = pathlib.Path(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt_dir and args.resume:
        last = ckpt.latest_step(ckpt_dir)
        if last is not None:
            state, extra = ckpt.restore(ckpt_dir, last, (params, opt_state))
            params, opt_state = _to_device(state, (params, opt_state))
            pipe.check_state(extra["pipeline"])
            start_step = last
            if first:
                print(f"resumed from step {last}", flush=True)

    step_fn = make_train_step(cfg, opt_cfg, microbatches=args.microbatches,
                              compress=args.compress)

    if ckpt_dir and first:
        ckpt_dir.mkdir(parents=True, exist_ok=True)
    saver = ckpt.AsyncSaver(ckpt_dir, write=first) if ckpt_dir else None
    hb = (ckpt_dir / "heartbeat.json") if ckpt_dir and first else None
    metrics_log = (ckpt_dir / "metrics.jsonl").open("a") \
        if ckpt_dir and first else None
    losses = []
    t0 = time.time()
    try:
        for step in range(start_step, args.steps):
            batch = pipe.batch_at(step, shard, args.microbatches)
            tokens = torch.from_numpy(batch["tokens"]).to(device)
            with activation_sharding(mesh, batch=args.batch):
                params, opt_state, m = step_fn(params, opt_state,
                                               {"tokens": tokens})
            loss = float(m["loss"])
            losses.append(loss)
            if hb:
                hb.write_text(json.dumps({"step": step, "t": time.time()}))
            if metrics_log and step % args.log_every == 0:
                metrics_log.write(json.dumps(
                    {"step": step, "loss": loss,
                     "grad_norm": float(m["grad_norm"]),
                     "lr": float(m["lr"])}) + "\n")
                metrics_log.flush()
            if first and step % args.log_every == 0:
                print(f"step {step}: loss={loss:.4f} "
                      f"gnorm={float(m['grad_norm']):.3f} "
                      f"({(time.time()-t0)/(step-start_step+1):.2f}s/step)",
                      flush=True)
            if args.die_at_step == step:
                if saver:
                    # deterministic fault injection: the failure comes after
                    # the last checkpoint completed, not racing the writer
                    saver.wait()
                # printed before the barrier: once a rank has passed it and
                # exited, the launcher may stop rank 0 at any moment
                if first:
                    print(f"SIMULATED FAILURE at step {step}", flush=True)
                dist.barrier()
                os._exit(42)
            if saver and (step + 1) % args.ckpt_every == 0:
                saver.save(step + 1, (params, opt_state),
                           extra={"pipeline": pipe.state_dict()})
        if saver:
            saver.save(args.steps, (params, opt_state),
                       extra={"pipeline": pipe.state_dict()})
            saver.wait()
        dist.barrier()
    finally:
        if metrics_log:
            metrics_log.close()
    if first:
        print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})",
              flush=True)
    return losses


if __name__ == "__main__":
    main()
