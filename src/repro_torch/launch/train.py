"""The trainer: config-driven, fault-tolerant, resumable (port of
``repro.launch.train``), on one CUDA card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
        --smoke --steps 200 --ckpt-dir /tmp/ckpt --resume [--device cpu]

Its flags, outputs and fault-tolerance contract are the reference's, plus
``--device`` (default ``cuda``; ``cpu`` for tests):
  * checkpoints every --ckpt-every steps (async, atomic, crc-verified) +
    final; --resume restarts from the latest DONE checkpoint;
  * the data pipeline is step-addressed, so a resume replays the exact
    sample order;
  * a heartbeat file (step + wallclock) is written every step, and
    ``metrics.jsonl`` every --log-every; --die-at-step N simulates a hard
    failure (exit 42) after the last checkpoint has landed.
It is the reference on a 1 x 1 mesh: one process, one card.  Several cards
(data or model parallel, ``--model-parallel`` > 1) wait for ROADMAP queue A
item 18, and activation sharding (item 15) is the identity here.  f32
matmuls keep torch's default precision (no TF32), so ``--dtype float32``
means what it means in the reference.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import time

import torch

from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import (DataPipeline, PipelineConfig,
                                       synthetic_corpus)
from repro_torch.index.engine import resolve_device
from repro_torch.models import init_params
from repro_torch.train.compress import init_residual
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.step import make_train_step
from repro_torch.tree import tree_map


def _to_device(tree, like):
    """Restored host leaves onto the device and type of ``like``'s."""
    return tree_map(lambda t, ref: torch.as_tensor(t).to(
        device=ref.device, dtype=ref.dtype), tree, like)


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
                    help="cuda (one card) or cpu")
    args = ap.parse_args(argv)

    if args.model_parallel != 1:
        raise NotImplementedError(
            "--model-parallel > 1 needs a mesh over several cards, which "
            "the port does not have yet (ROADMAP queue A item 18); it "
            "trains on one card")
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg)
    device = resolve_device(args.device)
    dtype = getattr(torch, args.dtype)

    corpus = synthetic_corpus(n_tokens=max(2_000_000,
                                           args.batch * (args.seq + 1) * 50),
                              vocab=cfg.vocab, seed=args.seed)
    pipe = DataPipeline(corpus, PipelineConfig(
        seq_len=args.seq, batch_size=args.batch, seed=args.seed))
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

    start_step = 0
    ckpt_dir = pathlib.Path(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt_dir and args.resume:
        last = ckpt.latest_step(ckpt_dir)
        if last is not None:
            state, extra = ckpt.restore(ckpt_dir, last, (params, opt_state))
            params, opt_state = _to_device(state, (params, opt_state))
            pipe.check_state(extra["pipeline"])
            start_step = last
            print(f"resumed from step {last}", flush=True)

    step_fn = make_train_step(cfg, opt_cfg, microbatches=args.microbatches,
                              compress=args.compress)

    if ckpt_dir:
        ckpt_dir.mkdir(parents=True, exist_ok=True)
    saver = ckpt.AsyncSaver(ckpt_dir) if ckpt_dir else None
    hb = (ckpt_dir / "heartbeat.json") if ckpt_dir else None
    metrics_log = (ckpt_dir / "metrics.jsonl").open("a") if ckpt_dir else None
    losses = []
    t0 = time.time()
    try:
        for step in range(start_step, args.steps):
            batch = pipe.batch_at(step)
            tokens = torch.from_numpy(batch["tokens"]).to(device)
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
            if step % args.log_every == 0:
                print(f"step {step}: loss={loss:.4f} "
                      f"gnorm={float(m['grad_norm']):.3f} "
                      f"({(time.time()-t0)/(step-start_step+1):.2f}s/step)",
                      flush=True)
            if args.die_at_step == step:
                if saver:
                    # deterministic fault injection: the failure comes after
                    # the last checkpoint completed, not racing the writer
                    saver.wait()
                print(f"SIMULATED FAILURE at step {step}", flush=True)
                os._exit(42)
            if saver and (step + 1) % args.ckpt_every == 0:
                saver.save(step + 1, (params, opt_state),
                           extra={"pipeline": pipe.state_dict()})
        if saver:
            saver.save(args.steps, (params, opt_state),
                       extra={"pipeline": pipe.state_dict()})
            saver.wait()
    finally:
        if metrics_log:
            metrics_log.close()
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})", flush=True)
    return losses


if __name__ == "__main__":
    main()
