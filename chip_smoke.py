#!/usr/bin/env python3
"""Smoke test of the torch port on one CUDA card: the learned-index read path,
its write path, planning and sharded serving, the LSM write plane and the
async front door, the device-sharded plane, RecurrentGemma-9B serving, the
attention families (gemma3-12b, internlm2-1.8b, gemma2-27b, minicpm-2b,
qwen3-moe-235b-a22b, arctic-480b, llama-3.2-vision-11b, whisper-medium)
and the xLSTM family (xlstm-350m), training on the card through the
trainer's mesh path on a one-rank NCCL group (the trainer at full width,
the RG-LRU scan's backward kernel, MoE, die and resume), serving under
that mesh, and the dry-run plane (the CLI, and its estimates held to the
card).

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It imports only the port (``src/repro_torch``), never JAX or the JAX package,
and fails (non-zero exit, no result line) where no CUDA card is present or
the port's sources are missing.  Phases, each of which raises on failure:

1. The card: name and power limit (``nvidia-smi``), torch and CUDA versions.
2. The build: compile ``csrc/fitting_lookup.cu``, ``flash_attention.cu``,
   ``rglru_scan.cu`` (the scan's forward and backward kernels) and
   ``shrinking_cone.cu`` with ``nvcc`` for sm_90a, one process each, all at
   once, and print ``ptxas``'s register/spill report.
3. The data: ``iot_like(2**23)`` keys, rescaled to [0, 2^23] and floored to
   integers (exact in f32; duplicates stay), a 32 MB f32 column on the card,
   fitted at each error e in {16, 64, 256} through ``Snapshot.from_arrays``.
4. Kernel vs plain: at Q = 2^20 queries per e, the fused search kernel
   (route + predict + window + snap, one launch) in each mode (lookup,
   search left, search right) against its plain torch twin on the card
   (tolerance 0), timed with CUDA events around one call (median of 25
   after warm-up; in turns fused, searchsorted, searchsorted, fused; and
   with L2 flushed) and by the profiler's kernel time, beside a
   whole-column ``torch.searchsorted`` as the library yardstick, the
   work's bound and the bytes each reads and writes.  Then the window
   search alone against its twin (exact rank and found), as before.  Then
   one 2^20-query search on the cuda backend: ``kernel_search`` must be
   one launch of the fused kernel with no host sync (counted by torch's
   sync debug mode, which must count the one in a ``nonzero``), its device
   time, and the engine call's host wall.
5. The read path: ``ServingHandle.install`` of each snapshot, then batches of
   1, 1,000 and 2^20 queries (3/4 drawn from the column, 1/4 uniform
   integers in [-2^10, 2^24 + 2^10]) through lookup / search (both sides) /
   point / count / range / predecessor / successor on the backends cuda,
   torch-window, torch-bisect and dispatch, every answer checked equal to
   ``np.searchsorted`` on the f32 column.  The fused kernel's launch count
   is set to 0 just before this phase and read just after; it must be > 0.
5b. The re-fit at the in-place cell's shape (``refit_phase``): one shard of
   the 2^24-key Weblogs column (the fifth of nine cuts, error 64, buffers
   of 16) before its fourth publish of 1,820 inserts; its dirty runs fitted
   by the batched ShrinkingCone kernel, equal to its twin, timed one call,
   in bursts and by the profiler beside its bound and the twin's wall;
   then ``flush`` on copies of the tree the per-segment way, batched on
   the host and batched on the card, medians of 3, the three trees equal.
6. The write path, planning and sharded serving, on the same column, with
   the fused kernel's launch count set to 0 before it and read after it
   (> 0; the batched ShrinkingCone's count too, from its publishes): ``calibrate_device`` times the dispatch tiers and fits the card's
   ``GPUCostParams``; ``plan`` resolves a latency budget (the e = 64
   candidate's own prediction, so feasible) with batches (1; 1,000; 2^20)
   and 65,536 inserts a second under that profile, prints ``explain()``,
   and ``open_index`` serves it on the card.  Then a 4-shard
   ``ShardedIndexService`` (e 64, buffer 16, cuda backend): 65,536 inserts
   (3/4 copies of existing keys, 1/4 uniform integers in [0, 2^23]) and a
   publish; 16,384 inserts into one shard's range and a publish, which must
   advance that shard's epoch alone and re-upload its device form alone;
   a rebalance, which must act; four more publish cycles, after each of
   which ``memory_allocated`` must stay within one generation of the
   shards' device forms and the view's (the shards end to end, which a read
   past one shard searches in one launch) plus ``MEM_SLACK``.  Every verb
   at 2^20 queries equals ``np.searchsorted`` on the merged column after
   each step.  Then one ``IndexService`` on the dispatch backend with the
   cost model's thresholds (the tier each of 1, 1,000 and 2^20 takes), 300
   dispatch batches of mixed sizes under a ``Monitor``, and one
   ``Replanner.replan()``.  It prints inserts a second, publish walls,
   ``search`` host walls (median of 5) at the three batch sizes, device
   memory per cycle and the thresholds before and after, each with the
   card line.
7. The LSM write plane and the async front door, on the same column, with
   the fused kernel's launch count set to 0 before each half and read after
   it (> 0).  The LSM: ``LsmIndexService`` (e 64, cuda, memtable 4,096,
   fanout 4) holds the 2^23 keys as one bulk run at level 6; 63 memtable
   fills of inserts (3/4 copies of existing keys, 1/4 uniform integers in
   [0, 2^23]), each followed by ``publish()`` (spill + one compaction
   step), then 4,096 deletes of existing keys, 4,096 upserts, and
   ``compact()`` until idle.  After each step search (both sides) and
   lookup at 2^20 queries, and point, predecessor, successor, count and
   range at 16 of them, equal ``np.searchsorted`` on the live multiset;
   ``memory_allocated`` stays within one generation of the live runs'
   device forms plus ``MEM_SLACK`` after the inserts and the compactions.
   It prints inserts a second, spills and compactions with their walls
   (the ``lsm.spill`` / ``lsm.compaction`` channels), runs per level, read
   amplification, and ``search`` host walls at 1, 1,000 and 2^20 beside
   the run count.  The front door: ``AsyncIndexService`` over a one-shard
   ``IndexService`` (e 64, dispatch on the cost model's thresholds, flush
   threshold at its ``large_min``, deadline 2 ms, prewarmed, a
   ``Monitor``): 16 caller threads, each making 512 requests of 1 to 64
   queries (lookup and search on both sides, up to 16 in flight), every
   answer checked; it prints queries a second, ``pipeline.sojourn`` p50
   and p99, flushes by cause, the mean fused batch, and the same traffic
   calling the service directly (plain, not a target).  Then
   ``open_pipeline`` on a write-heavy ``FitSpec`` (e 64, 65,536 inserts a
   second, batches of 2^20: an ``LsmIndexService`` on cuda, memtable
   16,384): 16 fills of inserts, the first 12 compacted in the
   foreground, then 8 reader threads run while the plan's cadence thread
   compacts; every answer equals the oracle and at least one compaction
   lands under the readers.
8. The device-sharded plane, on the same column, with the fused kernel's
   launch count set to 0 before it and read after it (> 0):
   ``DeviceShardedService`` (e 64, buffer 16, row headroom 1.0) with four
   rows on the card (``devices=["cuda:0"] * 4``); each row's search is one
   launch of the
   fused kernel.  With its exchange set in turn to allgather, a2a and
   auto, every verb at 1, 1,000 and 2^20 queries equals
   ``np.searchsorted`` and ``search(left)`` is timed (host wall, median of
   5).  16,384 inserts into row 1's range and a publish: exactly that
   row's five tensors change, the other three keep their ``data_ptr()``,
   and the uploaded bytes equal ``row_bytes() + 4 * replicated_bytes()``.
   A batch of 2^16 queries owned by row 0 on a2a at slack 1 is answered
   exactly and overflows into the allgather pass.  A rebalance is a full
   publish.  After each write step every verb at 2^20 equals the oracle;
   ``memory_allocated`` stays within one generation of the rows plus
   ``MEM_SLACK``.  It prints the walls beside phase 6's 4-shard
   ``ShardedIndexService`` at 2^20, with the card line.
9. LM kernels vs plain: ``flash_attention`` at the local layer's prefill
   (B 1, H 16, Hkv 1, T = S = 4096, hd 256, window 2048, bf16: the
   tensor-core kernel), then with softcap and GQA (hd 128, H 8, Hkv 4,
   T = S = 2048, f32) and non-causal (hd 64, f32), both on the CUDA-core
   kernel, one decode query against S = 4096 (bf16), the local prefill at
   hd 128 and non-causal at hd 64 in bf16 (tensor cores), and the
   attention families' shapes in bf16 (tensor cores): whisper-medium's
   encoder (B 2, H = Hkv = 16, T = S = 1,500, hd 64, non-causal),
   llama-3.2-vision's cross layers (B 1, H 32, Hkv 8, Tq 4,096 over S
   1,600 patches, hd 128, non-causal: q_offset = S - Tq < 0) and
   gemma2-27b's global layers (B 1, H 32, Hkv 16, T = S = 4,096, hd 128,
   causal, softcap 50, and the same without the cap); the RG-LRU
   scan at ``RGLRU_CASES``: B 4, T = W = 4096 with h0 (the headline), the
   batcher's prefill B 1, T 3,072, W 4,096 with h0, a ragged T (2, 1000,
   96), a ragged T and W (2, 1000, 100: a partial channel tile) and an
   unaligned (1, 37, 130), each naming the path
   (``scan_path``) it took.  Each against its plain twin (flash to
   ``FLASH_TOL``, with its reasons, and by the relative error of each
   64-row query block, ``kernels/ref.py`` ``block_rel_err`` within
   ``BLOCK_REL_TOL``; the scan exactly, max abs err 0), timed beside its
   bound and, for attention without softcap,
   ``scaled_dot_product_attention`` with the same boolean mask; the
   scan also in bursts of 20 back-to-back launches (its launch path
   hidden) with the wrapper's host wall beside, one call under the
   profiler split into the kernel's own time and the rest (the host span,
   its start to the launch call and to the kernel's start), and beside
   the unaligned kernel (the first design) on the same input through the
   private ``_rglru_scan_launch``.
10. Consistency: recurrentgemma-9b at full width, depth cut to one
   (rglru, rglru, local) unit plus one rglru layer, f32 with TF32 off for
   matmul and cuDNN: B 2, prefill 2,304 tokens (past the 2,048 window) +
   16 teacher-forced decode steps == a cache-free forward, rtol = atol =
   3e-2.
10b. Consistency of the attention families: each of the eight configs at
   full width, each unit (and encoder unit) repeated once, f32 with TF32
   off, B 2: prefill (past the local window where there is one; 64
   tokens for MoE, 256 otherwise) with the memory stub (N(0, 0.02)
   embeddings of 1,600 patches or 1,500 frames) where the family has one,
   + 16 teacher-forced decode steps == a cache-free forward, rtol = atol =
   3e-2.  MoE runs at capacity factor n_experts / top_k, so no token is
   dropped at either token count.  xlstm-350m too: one (m, m, m, s) unit,
   prefill 300 tokens (two mLSTM chunks of 256, the second padded).
11. Serving: recurrentgemma-9b at full width and depth (38 layers, 9.40 B
   parameters, bf16, drawn from seed 0 on the card): the prefill step at
   B 4, T 4,096 (timed, tokens/s), then ``ContinuousBatcher`` (4 slots,
   cache 4,160) drains 8 requests with prompts of 256 to 3,072 tokens and
   16 new tokens each; every request gets its 16 tokens, all in the
   vocabulary, and the logits are finite.  The LM kernels' launch counts
   are set to 0 just before this phase and must be > 0 after it; every
   scan launch of the phase must take the ``tma`` path (its counts by
   path are printed after the prefill and at the end).
11b. Serving the attention families in bf16 at full width, one at a time,
   each freed before the next: full depth, but qwen3-moe-235b-a22b cut to
   11 of 94 layers and arctic-480b to 2 of 35 (one card's 80 GB).  The
   prefill step at B 4, T 4,096 (whisper: its 448-token decoder context)
   with the memory stub where the family has one (timed, tokens/s, a
   profiled breakdown); for the MoE models that profile's device time by
   aten op: the expert products (``bmm``) beside the router's top-k, the
   dispatch (sort, searchsorted, gather, scatter) and the combine
   (``index_add_``); then the
   decoder-only models' ``ContinuousBatcher`` (4 slots, cache 1,056: f32
   caches, bf16 for MoE) drains 8 requests of 128 to 1,024 prompt tokens,
   16 new tokens each, and the vlm and audio models decode 16 greedy
   tokens through ``make_decode_step`` over the prefill's caches.  Every
   token in the vocabulary, logits finite; flash's launch count is set to
   0 before each model and must be > 0 after it; memory_allocated after
   the weights and at its peak.  The warm-up prefill records each
   distinct flash instantiation it makes (dtype, hd, H, Hkv, Tq, S,
   causal, window, softcap) with a copy of its batch-0 inputs; after the
   model is freed each is held against the twin on those inputs within
   ``FLASH_TOL`` and ``BLOCK_REL_TOL``, as phase 9's cases are.
   xlstm-350m serves 2 of its 6 repeats (``ARCH_SERVE``).
Training (phases 13 to 16b) runs on a one-rank NCCL process group
(``launch.mesh.init_ranks``; never ``gloo`` on the card) and a (data 1,
model 1) ``DeviceMesh``: every parameter a DTensor on cuda:0, placed by
the sharding rules, each step under ``activation_sharding(mesh)``.  Each
phase prints the backend, the mesh and the placement, and checks them,
and prints its losses, s/step and peak memory beside PR 19 call 13's
(the same trainer without a mesh, copied in ``C13``).
13. train_main, the trainer's main path: ``launch.train.main`` with
   ``TRAIN_ARGV`` (internlm2-1.8b at full width and depth, 1.89 B
   parameters, f32 with torch's default matmul precision, B 8, T 256, 6
   steps, parameters drawn from seed 0 on the card, the learned-index
   data pipeline on the host).  Every loss finite, the last below the
   first; each step timed between two synchronisations (s/step and
   tokens/s from the median after the first), step 3 once under the
   profiler (device time by kind, idle share), peak memory_allocated.
   No forward-only kernel may launch (flash and the scan count 0): the
   trainer's attention is the chunked torch path autograd differentiates.
   The losses must equal PR 19 c13's to the printed four decimals (at 1 x 1
   the mesh path computes bit for bit what the step without one does).
14. train_rglru: recurrentgemma-9b at full width cut to one (rglru, rglru,
   local) unit (1.71 B parameters), f32: 3 steps of ``make_train_step`` at
   B 2, T 2,048, parameters and state placed on the mesh by the rules and
   each step under ``activation_sharding``, with the scan's counts set to 0
   before and read after:
   the forward kernel must launch 12 times (``rglru_scan_cuda.launches``:
   each layer's forward and its recomputation under remat), the backward
   kernel 6 (``rglru_scan_backward_cuda.launches``: once a layer), all on
   the ``tma`` path.  The first step keeps the inputs and outputs of
   its first scan forward (u, a -> h) and first scan backward (g, a, h ->
   du, da); once the model is freed, each is held to the twin on the same
   inputs on the card with ``torch.equal`` (the backward to the forward
   twin on flipped time, ``scan_twin_backward``).  Then the backward
   kernel at ``RGLRU_BWD_SHAPES`` (B 4, T = W = 4,096, and the training
   shape B 2, T 2,048, W 4,096), f32: du and da ``torch.equal`` to its
   twin on the card, to the port's backward before the kernel (the forward
   kernel on time-flipped inputs, cats and a product: ``flip_backward``)
   and to one autograd backward; timed by CUDA events in turns kernel,
   old, old, kernel, in bursts of 20 and one call under the profiler (the
   kernel's own time, the wrapper's host span), beside the autograd
   backward, the twin and the bound (read g, a, h; write du, da: 5 x
   268,435,456 bytes at 3.35 TB/s, 0.4006 ms; 0.1002 ms at the training
   shape).
15. train_xlstm: ``launch.train.main`` with ``XLSTM_ARGV`` (xlstm-350m,
   B 8, T 256, 3 steps): finite, falling loss, s/step, tokens/s.
16. train_resume: ``python -m repro_torch.launch.train --smoke --steps 20
   --batch 2 --seq 64 --ckpt-every 10 --log-every 1`` in subprocesses on
   the card (checkpoints in a temporary directory): uninterrupted and
   ``--die-at-step 12`` (exit 42) at once, then ``--resume`` (prints
   ``resumed from step 10``); steps 10 to 19 within 1e-5 of the
   uninterrupted run (tests/test_substrate.py's bound); and a 12-step
   ``--compress`` run whose loss falls.  Each subprocess forms its own
   one-rank NCCL group; its ``mesh:`` line must name ``nccl`` and cuda:0.
16b. train_moe: ``launch.train.main`` with ``MOE_ARGV`` (reduced qwen3-moe,
   3 steps) with each call of ``blocks._apply_moe_xla`` and
   ``_apply_moe_shardmap`` counted: at a model axis of 1 every call takes
   the single-device dispatch, as the reference does; expert parallelism
   waits for several cards.
17. serve_mesh, on the same one-rank NCCL group: recurrentgemma-9b and
   internlm2-1.8b at full width and depth, qwen3-moe-235b-a22b at phase
   11b's 11 layers and xlstm-350m at phase 11b's 2 of its 6 repeats,
   bf16, each on a (data 1, model 1) mesh: parameters
   and caches placed by ``launch.specs.make_step_and_specs``'s placements
   (the caches' batch over the data axes), prefill at B 4, T 4,096 and 8
   greedy decode ticks through the steps it binds, against the same steps
   without a mesh on the same inputs (run before, to warm up, and after):
   every token ``torch.equal`` (the MoE model under deterministic
   algorithms, both ways).  It prints prefill tokens/s, the median tick
   and the peak beside the no-mesh run's and PERF.md §5's (copied).
   Flash and the scan are counted from 0 just before each model's run on
   the mesh and read just after it: flash must launch for every model with
   attention (not xlstm-350m), the scan for recurrentgemma-9b only, each
   as often as in the run without the mesh (counted the same way).
   recurrentgemma-9b also runs bound under the ``zero3`` policy on the same
   mesh (``ZERO3_ARCH``): tokens ``torch.equal`` to the run without the
   mesh, flash and scan launches equal to it, its prefill and tick times
   printed beside the ``2d`` mesh run's.
18. dryrun: (a) ``python -m repro_torch.launch.dryrun --arch xlstm-350m
   --shape decode_32k --multi-pod`` in a subprocess (a fake group of 512
   ranks, meta tensors): status ok, one rank's GiB (its arguments' shards
   and the traced temp), flops, wire bytes and collective counts printed
   (the xLSTM split over ``model`` 16); (b) internlm2-1.8b's train step (B 8, T 256 + 1), a prefill
   (B 8, T 256) and a decode step (B 8 over a 4,096 cache), bf16
   parameters, each built by ``make_step_and_specs`` on a one-rank (pod 1,
   data 1, model 1) mesh, traced on meta, then run on the card under
   ``FlopCounterMode``: the two flop counts equal exactly (the prefill's
   flash through its registered op, which launches the kernel); the
   estimate (the arguments' bytes plus the MemTracker temp) printed
   beside ``max_memory_allocated`` of the real step, with the ratio.
9b (after phase 9). The registered ops' cost: at each LM kernel's headline
   shape, one call of the wrapper the model calls (the direct launcher)
   and of ``flash_attention_op`` / ``rglru_scan_op`` (the dispatcher,
   then the same launcher), in turns direct, op, op, direct: CUDA-event
   ms, the launch path's host us and the profiler's host span.
9c (after phase 9). Flash at the per-rank heads of tensor parallelism
   over a 16-way ``model`` axis (``FLASH_TP_ARCHS``: H / 16 q heads over
   Hkv / 16 kv heads, or the one kv head they group into where Hkv does
   not divide; where H does not divide (minicpm-2b, arctic; case C), the
   heads rank 0's columns touch over the kv heads those group into; each
   layer kind's causal, window and soft-cap; B 1, T = S = 4,096, bf16), each against the twin within ``FLASH_TOL`` and
   ``BLOCK_REL_TOL``, its card ms beside its bound, beside the whole-head
   call's on the same card and, where there is no soft-cap, beside
   ``scaled_dot_product_attention``'s on the same inputs (kv heads
   expanded, the same boolean mask); recorded in flash's ``tp16_shapes``
   (its launches, comparisons alone, in ``tp16_launches``, not in
   ``launches``).
9d (after phase 9). The RG-LRU scan at a rank's channels under a 16-way
   ``model`` axis (``RGLRU_TP_SHAPES``: recurrentgemma-9b's W = 4,096 split
   to 256, f32): the forward kernel at B 4, T 4,096 with h0 and at the
   prefill_32k rank's B 2, T 32,768; the backward kernel at the training
   shape's B 2, T 2,048 and at the train_4k rank's B 16, T 4,096 (g, a and
   the forward kernel's states).  Each ``torch.equal`` to its twin on the
   card, its ``scan_path``, its CUDA-event ms beside its bound (forward:
   read u, a, h0, write the states and h_last; backward: read g, a, h,
   write du, da) and the twin's, and the whole-width call's ms on the same
   card; recorded in the scan's ``tp16_shapes`` (launches, comparisons
   alone, by direction in ``tp16_launches``, not in ``launches``).
12. (printed last) A text line with the three redesigned kernels' earlier
   times, copied from PERF.md and marked so, beside this run's; a
   ``{"training": ...}`` line with phases 13 to 16b; a ``{"kernels":
   [...]}`` line (all three kernels, each with its design, every number
   from this run; the fused search's launches are the read path's, the write
   path's, the LSM's, the pipeline's and the device plane's; flash's are
   phase 11's and 11b's, by architecture in ``launches_by_arch``, and
   phase 17's mesh runs (``launches_serve_mesh``, by architecture in
   ``launches_serve_mesh_by_arch``); the scan's are phase 11's, 14's
   and 17's forward launches, by phase in ``launches_by_phase``, with the
   backward kernel's own record under ``backward``: its design, phase 14's
   launches by path, its checks and times at both shapes), the card line
   again, and last ``{"ok": true, "device":
   {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
N_KEYS = 2 ** 23
ERRORS = (16, 64, 256)
Q_KERNEL = 2 ** 20
BATCHES = (1, 1000, 2 ** 20)
BACKENDS = ("cuda", "torch-window", "torch-bisect", "dispatch")
DISPATCH = {"small_max": 1, "large_min": 4096}   # numpy / torch-bisect / cuda
HEADLINE = (64, "left")                          # the case the kernels line reports
REPS = 25
# The kernels' times before this design, copied from PERF.md §6's table
# (H100 80GB HBM3 at 700 W), not measured here: printed on a text line of
# their own beside this run's, never in the kernels line.
EARLIER_MS = {"fitting_lookup": (0.3266, "window kernel alone, one warp a "
                                         "query"),
              "flash_attention": (5.7646, "CUDA-core f32 kernel"),
              "rglru_scan": (0.5021, "one thread a channel, 16 steps' "
                                     "loads ahead")}

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s, f32 non-tensor op/s
HBM_BPS = 3.35e12
F32_OPS = 67e12


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(torch, fn, *, flush=None, warmup: int = 3, reps: int = REPS):
    """Median device time of ``fn`` in ms, by CUDA events around each call;
    ``flush`` (a large tensor) is overwritten before each call to evict L2."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def burst_ms(torch, fn, burst: int = 20, reps: int = REPS) -> float:
    """Median device time in ms of one call of ``fn`` when ``burst`` calls
    run back to back between two CUDA events.  Where the host's launch path
    is shorter than the kernel, it overlaps the kernels before it and this
    is the kernel's own time plus the gap between two launches; where it is
    longer (``host_us`` says), this is the launch path's rate."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(burst):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / burst)
    return float(np.median(times))


def host_us(torch, fn, reps: int = REPS) -> float:
    """Median host wall in us of one call of ``fn`` (no synchronisation:
    the launch path alone), after a synchronised warm-up."""
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        walls.append((time.perf_counter() - t0) * 1e6)
        torch.cuda.synchronize()
    return float(np.median(walls))


def device_ms(torch, fn, kernel: str, reps: int = 10) -> float | None:
    """Mean device time in ms of the kernels whose name holds ``kernel``
    over ``reps`` calls of ``fn``, from ``torch.profiler``: the kernel's own
    time, without the launch cost that CUDA events around one call take in
    (it matters below 0.1 ms).  The profiler on the card at times records
    no kernel at all; after three such tries this is None, printed as not
    measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(ev.time_range.elapsed_us() for ev in prof.events()
                 if ev.device_type == DeviceType.CUDA and kernel in ev.name)
        if us:
            return us / reps / 1e3
    return None


def one_call_profile(torch, fn, kernel: str, reps: int = 10,
                     lead_ms: float = 50.0) -> dict:
    """One call of ``fn`` at a time, as ``median_ms`` times it (a start
    event, the call, an end event, a wait), under ``torch.profiler`` on the
    host and the card.  Late in a long process the profiler has recorded
    only a few of a short session's kernels, so the session first runs
    calls unmeasured for ``lead_ms``.  Each measured call is a
    ``record_function`` range, which the profiler also places on the card
    around the call's kernels; a call counts where that range and a kernel
    whose name holds ``kernel`` inside it were recorded (``recorded`` of
    ``reps``).  Medians over those calls of: the CUDA events' ms; the
    kernel's own ms; the ms from the start event to the end event that the
    kernel does not cover; the host span of ``fn`` in us; and the us from
    the span's start to its first ``cudaLaunchKernel`` and to the kernel's
    start (these two compare host and card timestamps).  The profiler's
    host tracing lengthens the host span."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    fn()
    torch.cuda.synchronize()
    event_ms = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while (time.perf_counter() - t0) * 1e3 < lead_ms:
            fn()
            torch.cuda.synchronize()
        for i in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            with record_function(f"one_call_{i}"):
                fn()
            end.record()
            end.synchronize()
            event_ms.append(start.elapsed_time(end))
    events = prof.events()
    spans, ranges = {}, {}
    for ev in events:
        if ev.name.startswith("one_call_"):
            side = spans if ev.device_type == DeviceType.CPU else ranges
            side[int(ev.name.rsplit("_", 1)[1])] = ev.time_range
    launches = sorted(ev.time_range.start for ev in events
                      if ev.device_type == DeviceType.CPU
                      and ev.name == "cudaLaunchKernel")
    kernels = sorted((ev.time_range.start, ev.time_range.end)
                     for ev in events if ev.device_type == DeviceType.CUDA
                     and kernel in ev.name)
    rows = []
    for i in range(reps):
        span, rng = spans.get(i), ranges.get(i)
        if span is None or rng is None:
            continue
        ks = [k for k in kernels if rng.start <= k[0] <= rng.end]
        if not ks:
            continue
        k0, k1 = ks[0]
        ls = [t for t in launches if span.start <= t < span.end]
        rows.append((event_ms[i], (k1 - k0) / 1e3,
                     event_ms[i] - (k1 - k0) / 1e3, span.end - span.start,
                     ls[0] - span.start if ls else None, k0 - span.start))
    out = {"reps": reps, "recorded": len(rows)}
    for j, key in enumerate(("event_ms", "kernel_ms", "outside_kernel_ms",
                             "host_span_us", "to_launch_us",
                             "to_kernel_us")):
        vals = [r[j] for r in rows if r[j] is not None]
        out[key] = float(np.median(vals)) if vals else None
    return out


def fmt_ms(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def fmt_us(us: float | None) -> str:
    return "not measured" if us is None else f"{us:.1f}"


def make_keys() -> np.ndarray:
    from repro_torch.core.datasets import iot_like
    from repro_torch.core.torch_index import rescale_keys
    scaled, _, _ = rescale_keys(iot_like(N_KEYS, seed=SEED))
    keys = np.floor(scaled)
    if keys[-1] > 2 ** 24 or np.any(np.diff(keys) < 0):
        raise AssertionError("keys must be sorted integers <= 2^24")
    return keys


def make_queries(keys: np.ndarray, size: int, rng) -> np.ndarray:
    """3/4 drawn from the column, 1/4 uniform integers around its domain."""
    from_col = keys[rng.integers(0, keys.shape[0], size)]
    uniform = rng.integers(-2 ** 10, 2 ** 24 + 2 ** 10, size,
                           endpoint=True).astype(np.float64)
    return np.where(rng.random(size) < 0.75, from_col, uniform)


def covered_keys(torch, qlo, window: int, n: int) -> int:
    """Distinct in-column key indices the windows [qlo, qlo+W) touch."""
    s = torch.sort(qlo.to(torch.int64)).values
    ends = (s + window).clamp(max=n)
    nxt = torch.cat([s[1:], ends[-1:]])
    return int((torch.minimum(ends, nxt) - s).clamp(min=0).sum())


def l2_sectors(torch, qlo, window: int, n: int) -> int:
    """32-byte sectors the warps fetch from L2: each query's window
    [qlo, qlo+W) within the column, in whole sectors."""
    lo = qlo.to(torch.int64) * 4
    hi = (qlo.to(torch.int64) + window).clamp(max=n) * 4
    return int((torch.div(hi + 31, 32, rounding_mode="floor")
                - torch.div(lo, 32, rounding_mode="floor")).clamp(min=0).sum())


def kernel_vs_plain(torch, dev, snapshots, keys, flush, l2_bps):
    """Phase 4: exact equality and timings at n = 2^23, Q = 2^20: the fused
    search (route + predict + window + snap, one launch) in all three modes
    against its twin, and the window search alone against its twin."""
    from repro_torch.index.engine import device_index, make_plan, \
        predict_positions
    from repro_torch.kernels.fitting_lookup import (
        MODES, fitting_lookup_cuda, fitting_lookup_torch, fitting_search_cuda,
        fitting_search_torch)
    rng = np.random.default_rng(SEED + 1)
    q_host = make_queries(keys, Q_KERNEL, rng)
    cases, fused = [], []
    for e in ERRORS:
        idx = device_index(snapshots[e].table, dev)
        n = idx.keys.shape[0]
        n_seg = idx.seg_start.shape[0]
        plan = make_plan(n, e)
        q = torch.tensor(q_host.astype(np.float32), device=dev)
        qlo = (predict_positions(idx, q) - e).clamp(0, plan.n_pad - plan.window)
        args = (idx.keys, q, qlo)
        kw = {"window": plan.window, "n_pad": plan.n_pad}
        covered = covered_keys(torch, qlo, plan.window, n)
        l2_bytes = 32 * l2_sectors(torch, qlo, plan.window, n)
        ops = 2 * Q_KERNEL * plan.window        # one order, one equality
        op_ms = ops / F32_OPS * 1e3
        for mode in MODES:
            fargs = (*idx[:5], q)
            fkw = {"error": e, "n_pad": plan.n_pad, "mode": mode}
            got = fitting_search_cuda(*fargs, **fkw)
            want = fitting_search_torch(*fargs, **fkw)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            if err:
                raise AssertionError(f"fused kernel != plain at e={e} "
                                     f"{mode}: max rank diff {err}")
            side = "right" if mode == "search-right" else "left"
            # the work's bytes: queries and results, the segment table and
            # the column keys the windows cover, each once
            nbytes = 4 * covered + 16 * n_seg + Q_KERNEL * (4 + 4)
            byte_ms = nbytes / HBM_BPS * 1e3
            row = {"error": e, "mode": mode, "window": plan.window,
                   "segments": n_seg, "max_abs_err": err,
                   "bytes": nbytes, "ops": ops,
                   "bound_ms": max(byte_ms, op_ms),
                   "bound_by": ("bytes" if byte_ms >= op_ms
                                else "operations")}
            # fused, library, library, fused: turns within one call
            fms = [median_ms(torch, lambda: fitting_search_cuda(*fargs,
                                                                **fkw))]
            lms = [median_ms(torch, lambda: torch.searchsorted(
                idx.keys, q, side=side)) for _ in range(2)]
            fms.append(median_ms(torch, lambda: fitting_search_cuda(*fargs,
                                                                    **fkw)))
            row.update(ms=float(np.mean(fms)), ms_runs=fms,
                       library_ms=float(np.mean(lms)), library_runs=lms,
                       device_ms=device_ms(torch, lambda: fitting_search_cuda(
                           *fargs, **fkw), "fitting_search_kernel"),
                       library_device_ms=device_ms(
                           torch, lambda: torch.searchsorted(
                               idx.keys, q, side=side), "searchsorted"),
                       # searchsorted reads the queries and the column and
                       # writes int64 ranks
                       library_bytes=Q_KERNEL * (4 + 8) + 4 * n,
                       cold_ms=median_ms(torch, lambda: fitting_search_cuda(
                           *fargs, **fkw), flush=flush),
                       plain_ms=median_ms(torch, lambda: fitting_search_torch(
                           *fargs, **fkw), reps=5, warmup=1))
            fused.append(row)
            print(f"fused e={e:3d} {mode:12s} W={plan.window:3d} "
                  f"S={n_seg}: equal; kernel {row['ms']:.4f} ms "
                  f"({fms[0]:.4f}, {fms[1]:.4f}; L2 flushed "
                  f"{row['cold_ms']:.4f}; profiler "
                  f"{fmt_ms(row['device_ms'])}), "
                  f"plain {row['plain_ms']:.4f} ms, searchsorted "
                  f"{row['library_ms']:.4f} ms ({lms[0]:.4f}, {lms[1]:.4f}; "
                  f"profiler {fmt_ms(row['library_device_ms'])}), bound "
                  f"{row['bound_ms']:.4f} ms (the work's bytes "
                  f"{nbytes / 1e6:.1f} MB; searchsorted's "
                  f"{row['library_bytes'] / 1e6:.1f} MB)", flush=True)
        for side in ("left", "right"):
            rk, fk = fitting_lookup_cuda(*args, side=side, **kw)
            rp, fp = fitting_lookup_torch(*args, side=side, **kw)
            torch.cuda.synchronize()
            err = int((rk - rp).abs().max())
            flags = int((fk != fp).sum())
            if err or flags:
                raise AssertionError(f"kernel != plain at e={e} side={side}: "
                                     f"max rank diff {err}, {flags} flags")
            ms = median_ms(torch, lambda: fitting_lookup_cuda(*args, side=side,
                                                              **kw))
            cold_ms = median_ms(torch, lambda: fitting_lookup_cuda(
                *args, side=side, **kw), flush=flush)
            plain_ms = median_ms(torch, lambda: fitting_lookup_torch(
                *args, side=side, **kw))
            lib_ms = median_ms(torch, lambda: torch.searchsorted(
                idx.keys, q, side=side))
            nbytes = 4 * covered + Q_KERNEL * (4 + 4 + 4 + 1)
            byte_ms = nbytes / HBM_BPS * 1e3
            cases.append({
                "error": e, "side": side, "window": plan.window,
                "max_abs_err": err, "found_mismatches": flags,
                "ms": ms, "cold_ms": cold_ms, "plain_ms": plain_ms,
                "library_ms": lib_ms, "bound_ms": max(byte_ms, op_ms),
                "bound_by": "bytes" if byte_ms >= op_ms else "operations",
                "dram_bytes": nbytes, "ops": ops, "covered_keys": covered,
                "l2_bytes": l2_bytes, "l2_ms": l2_bytes / l2_bps * 1e3,
            })
            print(f"window e={e:3d} {side:5s} W={plan.window:3d}: equal; "
                  f"kernel {ms:.4f} ms (L2 flushed {cold_ms:.4f}), plain "
                  f"{plain_ms:.4f} ms, searchsorted {lib_ms:.4f} ms, bound "
                  f"{max(byte_ms, op_ms):.4f} ms, L2 estimate "
                  f"{cases[-1]['l2_ms']:.4f} ms ({l2_bytes / 1e6:.0f} MB of "
                  f"sectors)", flush=True)
    return fused, cases


def l2_read_rate(torch, dev) -> float:
    """Achieved L2 read rate (bytes/s): one reduction reads a 16 MB
    L2-resident tensor 64 times over (a stride-0 view, nothing copied)."""
    x = torch.ones(4 * 2 ** 20, dtype=torch.float32, device=dev)
    rows = x.expand(64, -1)
    ms = median_ms(torch, lambda: rows.sum(1), warmup=5)
    return rows.numel() * 4 / (ms * 1e-3)


def count_syncs(torch, fn):
    """``fn()`` and the number of synchronising CUDA operations torch's
    sync debug mode reports in it (mode "warn": one warning each)."""
    import warnings
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def breakdown(torch, dev, snapshot, keys):
    """Where one search(left) of Q = 2^20 queries goes on the cuda backend at
    the headline error: ``kernel_search`` on device tensors is one launch of
    the fused kernel and no host sync (counted by torch's sync debug mode,
    whose count is first shown to see the ``nonzero`` sync the torch
    backends' snap takes); its device time (CUDA events), the queries its
    snap moved, and the engine call from and to host arrays (host wall,
    copies included)."""
    from repro_torch.index import make_engine
    from repro_torch.index.engine import kernel_search, make_plan, \
        predict_positions
    from repro_torch.kernels.fitting_lookup import (fitting_lookup_cuda,
                                                    fitting_search_cuda)
    e = HEADLINE[0]
    eng = make_engine(snapshot.table, "cuda", device=dev)
    idx = eng.index
    q_host = make_queries(keys, Q_KERNEL, np.random.default_rng(SEED + 3))
    q = torch.tensor(q_host.astype(np.float32), device=dev)
    plan = make_plan(idx.keys.shape[0], e)
    kernel_search(idx, q, "left")
    torch.cuda.synchronize()
    _, probe = count_syncs(torch, lambda: (q > 0).nonzero())
    if probe < 1:
        raise AssertionError("the sync count missed the sync of nonzero")
    before = fitting_search_cuda.launches
    final, syncs = count_syncs(torch, lambda: kernel_search(idx, q, "left"))
    launches = fitting_search_cuda.launches - before
    if launches != 1 or syncs:
        raise AssertionError(f"kernel_search took {launches} launches and "
                             f"{syncs} host syncs")
    qlo = (predict_positions(idx, q) - e).clamp(0, plan.n_pad - plan.window)
    window_rank = fitting_lookup_cuda(idx.keys, q, qlo, window=plan.window,
                                      n_pad=plan.n_pad, side="left")[0]
    parts = {"error": e, "q": Q_KERNEL, "launches": launches,
             "host_syncs": syncs, "probe_syncs": probe,
             "snapped": int((final != window_rank).sum()),
             "kernel_search_ms": median_ms(torch, lambda: kernel_search(
                 idx, q, "left"))}
    walls = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        eng.search(q_host, "left")
        walls.append((time.perf_counter() - t0) * 1e3)
    parts["engine_search_wall_ms"] = float(np.median(walls))
    print("breakdown of search(left), cuda, e={error}, Q={q}: kernel_search "
          "is {launches} launch of the fused kernel and {host_syncs} host "
          "syncs (the count saw {probe_syncs} in one nonzero), "
          "{kernel_search_ms:.4f} ms device ({snapped} queries "
          "snapped); engine.search {engine_search_wall_ms:.3f} ms host "
          "wall".format(**parts), flush=True)
    return parts


def check_verbs(handle, backend, keys, k32, q, rng):
    """Every verb of one batch on one backend against np.searchsorted."""
    n = keys.shape[0]
    q32 = q.astype(np.float32)
    left = np.searchsorted(k32, q32, "left")
    right = np.searchsorted(k32, q32, "right")
    found = (left < n) & (keys[np.minimum(left, n - 1)] == q)

    def same(name, got, want):
        if got.shape != want.shape or not np.array_equal(got, want):
            bad = np.flatnonzero(np.asarray(got).ravel() != want.ravel())
            raise AssertionError(f"{backend} {name}: {bad.size} mismatches "
                                 f"of {want.size}, first at {bad[:5]}")

    t0 = time.perf_counter()
    got = handle.search(q, "left", backend=backend)
    search_ms = (time.perf_counter() - t0) * 1e3
    same("search left", got, left)
    same("search right", handle.search(q, "right", backend=backend), right)
    same("lookup", handle.lookup(q, backend=backend), np.where(found, left, -1))
    pt = handle.point(q, backend=backend)
    same("point.rank", pt.rank, np.where(found, left, -1))
    same("point.found", pt.found, found)
    pr = handle.predecessor(q, backend=backend)
    same("predecessor", pr.rank, np.where(right > 0, right - 1, -1))
    sc = handle.successor(q, backend=backend)
    same("successor", sc.rank, np.where(left < n, left, -1))
    hi = q + rng.integers(-8, 2 ** 12, q.shape[0])     # some inverted
    want = np.maximum(np.searchsorted(k32, hi.astype(np.float32), "right")
                      - left, 0)
    same("count", handle.count(q, hi, backend=backend), want)
    for lo_, hi_ in ((q[0], q[0] + 2 ** 12), (q[0], q[0] - 1),
                     (-2.0 ** 11, -1.0), (2.0 ** 24 + 1, 2.0 ** 25),
                     (-2.0 ** 11, 2.0 ** 25)):
        r = handle.range(lo_, hi_, materialize=True, backend=backend)
        lo_r = int(np.searchsorted(k32, np.float32(lo_), "left"))
        hi_r = max(int(np.searchsorted(k32, np.float32(hi_), "right")), lo_r)
        if (r.lo_rank, r.hi_rank) != (lo_r, hi_r) or \
                not np.array_equal(r.keys, keys[lo_r:hi_r]):
            raise AssertionError(f"{backend} range [{lo_}, {hi_}]: got "
                                 f"[{r.lo_rank}, {r.hi_rank}) want "
                                 f"[{lo_r}, {hi_r})")
    return search_ms


def read_path(torch, snapshots, keys):
    """Phase 5: the port's read path through ServingHandle, every verb."""
    from repro_torch.index import ServingHandle
    k32 = keys.astype(np.float32)
    rng = np.random.default_rng(SEED + 2)
    timings = []
    for e in ERRORS:
        handle = ServingHandle(engine_opts={"dispatch": dict(DISPATCH)})
        handle.install(snapshots[e])
        for size in BATCHES:
            q = make_queries(keys, size, rng)
            for backend in BACKENDS:
                ms = check_verbs(handle, backend, keys, k32, q, rng)
                timings.append({"error": e, "batch": size,
                                "backend": backend, "search_ms": ms})
                print(f"read path e={e:3d} batch={size:7d} {backend:12s}: "
                      f"all verbs equal np.searchsorted; search(left) "
                      f"{ms:.3f} ms host wall", flush=True)
    return timings

# ------------------------------------------------------------ write path
WRITE_ERROR, WRITE_SHARDS, WRITE_BUFFER = 64, 4, 16
N_INSERTS, N_HOT, N_CYCLE, N_ONE = 65_536, 16_384, 1_024, 4_096
PLAN_BATCHES = (1, 1000, 2 ** 20)
INSERT_RATE = 65_536.0
# memory_allocated may exceed the live generation of device forms by this
# much after a publish cycle: below one shard's column (8 MB), so a shard
# generation left behind shows.
MEM_SLACK = 4 * 2 ** 20


def make_inserts(keys: np.ndarray, size: int, rng, lo=0, hi=2 ** 23):
    """3/4 copies of existing keys in [lo, hi) (duplicates run), 1/4
    uniform integers in [lo, hi]: integers, exact in f32."""
    pool = keys[(keys >= lo) & (keys < hi)]
    copies = pool[rng.integers(0, pool.shape[0], size)]
    uniform = rng.integers(lo, hi, size, endpoint=True).astype(np.float64)
    return np.where(rng.random(size) < 0.75, copies, uniform)


def device_forms(svc, dev):
    """Each shard's device form of its installed snapshot (None if its
    table was never placed on ``dev``)."""
    return [h.current().table._device_cache.get(dev) for h in svc.handles]


def view_form(svc, dev):
    """The device form of the service's last pinned view past one shard
    (None before one was read on ``dev``)."""
    view = svc._view
    return None if view is None else \
        view[2].current().table._device_cache.get(dev)


def forms_bytes(forms) -> int:
    """Bytes of device forms (keys and four segment fields; None skipped)."""
    return sum(f.keys.numel() * 4 + f.seg_start.numel() * 16
               for f in forms if f is not None)


def check_reupload(svc, dev, before, published, what):
    """After a publish and a read: exactly the published shards hold new
    device forms; every clean shard keeps its tensors."""
    after = device_forms(svc, dev)
    fresh = [d for d, (a, b) in enumerate(zip(before, after)) if a is not b]
    if fresh != sorted(published) or any(a is None for a in after):
        raise AssertionError(f"{what}: re-uploaded shards {fresh}, "
                             f"published {sorted(published)}")
    return len(fresh)


def search_walls(svc, keys, rng, backend=None):
    """Median host wall (ms) of ``search(left)`` at each of PLAN_BATCHES,
    host arrays in and out, over 5 calls after one warm-up."""
    out = {}
    for size in PLAN_BATCHES:
        q = make_queries(keys, size, rng)
        svc.search(q, "left", backend=backend)
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            svc.search(q, "left", backend=backend)
            walls.append((time.perf_counter() - t0) * 1e3)
        out[size] = float(np.median(walls))
    return out


def engine_walls(svc, keys, rng) -> float:
    """Median host wall (ms) of the shards' own cuda engine calls, each on
    its share of Q_KERNEL queries routed beforehand: what a sharded search
    that routed on the host spent in its engines, beside the one engine
    call over the view that answers it now."""
    from repro_torch.index.table import route_keys
    q = make_queries(keys, Q_KERNEL, rng)
    sid = route_keys(svc.boundaries, q)
    parts = [(h.engine("cuda"), q[sid == d])
             for d, h in enumerate(svc.handles)]
    walls = []
    for _ in range(6):
        t0 = time.perf_counter()
        for eng, part in parts:
            eng.search(part, "left")
        walls.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(walls[1:]))


def write_path(torch, dev, keys, card):
    """Phase 6: the write path, planning and sharded serving on the card
    (see the module docstring)."""
    import gc
    from repro_torch.core.cost_model import calibrate_device
    from repro_torch.index.fit import FitSpec, open_index, plan
    from repro_torch.index.telemetry import Monitor, Replanner
    from repro_torch.serve import IndexService, ShardedIndexService
    rng = np.random.default_rng(SEED + 4)
    tag = f"[{card}]"
    rec = {}

    def verbs(svc, merged, what, backend=None):
        m32 = merged.astype(np.float32)
        q = make_queries(merged, Q_KERNEL, rng)
        check_verbs(svc, backend, merged, m32, q, rng)
        print(f"write path, {what}: every verb at {Q_KERNEL} queries equals "
              f"np.searchsorted on the merged column", flush=True)

    # 1. plan under the calibrated profile, build, serve
    t0 = time.perf_counter()
    cpu_p, gpu_p = calibrate_device(keys, device=dev)
    rec["calibrate_s"] = time.perf_counter() - t0
    rec["gpu_params"] = vars(gpu_p)
    rec["cpu_c_ns"] = cpu_p.c_ns
    print(f"calibrate_device ({rec['calibrate_s']:.1f} s): {gpu_p}; host "
          f"c_ns {cpu_p.c_ns:.4f} {tag}", flush=True)
    base = {"batch_sizes": PLAN_BATCHES, "insert_rate": INSERT_RATE,
            "hardware": "gpu", "cpu_params": cpu_p, "gpu_params": gpu_p}
    probe = plan(keys, FitSpec(error=WRITE_ERROR, **base), assume_sorted=True)
    # feasible by construction: the e = 64 candidate's own predicted latency
    budget = next(c.latency_ns for c in probe.candidates
                  if c.error == WRITE_ERROR)
    planned = plan(keys, FitSpec(latency_budget_ns=budget, **base),
                   assume_sorted=True)
    print(planned.explain(), flush=True)
    t0 = time.perf_counter()
    svc = open_index(keys, planned, assume_sorted=True)
    print(f"open_index: {type(svc).__name__}, {svc.n_shards} shards, backend "
          f"{svc.default_backend} ({time.perf_counter() - t0:.1f} s)")
    verbs(svc, keys, f"planned service ({planned.backend})")
    rec["plan"] = {"error": planned.error, "n_shards": planned.n_shards,
                   "backend": planned.backend, "budget_ns": budget,
                   "small_max": planned.small_max,
                   "large_min": planned.large_min}
    del svc
    gc.collect()

    # 2. the sharded write path
    mem_base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    svc = ShardedIndexService(keys, error=WRITE_ERROR, n_shards=WRITE_SHARDS,
                              buffer_size=WRITE_BUFFER, skew_threshold=1.0,
                              assume_sorted=True)
    print(f"sharded service: {svc.n_shards} shards, backend "
          f"{svc.default_backend}, built in {time.perf_counter() - t0:.1f} s")
    svc.search(keys[:1])                       # every shard on the card
    forms = device_forms(svc, dev)
    ins = make_inserts(keys, N_INSERTS, rng)
    t0 = time.perf_counter()
    for k in ins:
        svc.insert(float(k))
    rec["inserts_per_s"] = N_INSERTS / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    published = svc.publish()
    wall = (time.perf_counter() - t0) * 1e3
    rec["publish_ms"] = wall
    rec["publish_ms_per_dirty_shard"] = wall / max(len(published), 1)
    merged = np.sort(np.concatenate([keys, ins]))
    verbs(svc, merged, f"after {N_INSERTS} inserts")
    rec["uploads_first_publish"] = check_reupload(svc, dev, forms, published,
                                                  "first publish")
    print(f"inserts: {rec['inserts_per_s']:.0f} a second; publish of "
          f"{len(published)} dirty shards {wall:.1f} ms "
          f"({rec['publish_ms_per_dirty_shard']:.1f} ms a shard); "
          f"{rec['uploads_first_publish']} device_index conversions; epochs "
          f"{svc.epochs()} {tag}", flush=True)

    hot = int(np.argmax([h.current().n_keys for h in svc.handles]))
    bounds = svc.boundaries
    lo = int(np.ceil(bounds[hot]))
    hi = int(bounds[hot + 1]) - 1 if hot + 1 < len(bounds) else 2 ** 23
    epochs, forms = svc.epochs(), device_forms(svc, dev)
    hot_keys = make_inserts(merged, N_HOT, rng, lo, hi)
    for k in hot_keys:
        svc.insert(float(k))
    t0 = time.perf_counter()
    published = svc.publish()
    rec["hot_publish_ms"] = (time.perf_counter() - t0) * 1e3
    merged = np.sort(np.concatenate([merged, hot_keys]))
    verbs(svc, merged, f"after {N_HOT} inserts into shard {hot}")
    want = [e + (d == hot) for d, e in enumerate(epochs)]
    if sorted(published) != [hot] or svc.epochs() != want:
        raise AssertionError(f"hot publish: published {sorted(published)}, "
                             f"epochs {epochs} -> {svc.epochs()}")
    rec["uploads_hot_publish"] = check_reupload(svc, dev, forms, published,
                                                "hot publish")
    print(f"hot shard {hot} [{lo}, {hi}]: publish {rec['hot_publish_ms']:.1f}"
          f" ms, epochs {epochs} -> {svc.epochs()} (only the dirty shard), "
          f"{rec['uploads_hot_publish']} device_index conversion {tag}",
          flush=True)
    t0 = time.perf_counter()
    moved = svc.rebalance()
    if moved is None:
        raise AssertionError(f"rebalance did not act (imbalance "
                             f"{svc.imbalance():.4f})")
    rec["rebalance"] = {**moved, "ms": (time.perf_counter() - t0) * 1e3}
    verbs(svc, merged, "after rebalance")
    print(f"rebalance: {moved} in {rec['rebalance']['ms']:.1f} ms; "
          f"boundaries {bounds.tolist()} -> {svc.boundaries.tolist()} {tag}",
          flush=True)

    mem = []
    gen = 0
    for c in range(4):
        d = c % WRITE_SHARDS
        b = svc.boundaries
        lo = int(np.ceil(b[d]))
        hi = int(b[d + 1]) - 1 if d + 1 < len(b) else 2 ** 23
        forms = device_forms(svc, dev)
        for k in make_inserts(merged, N_CYCLE, rng, lo, hi):
            svc.insert(float(k))
        published = svc.publish()
        svc.search(make_queries(merged, Q_KERNEL, rng))
        check_reupload(svc, dev, forms, published, f"cycle {c}")
        del forms, published        # the retired generation's last holders
        torch.cuda.synchronize()
        gc.collect()
        mem.append(torch.cuda.memory_allocated() - mem_base)
        gen = forms_bytes(device_forms(svc, dev) + [view_form(svc, dev)])
    rec["memory_bytes"] = mem
    rec["generation_bytes"] = gen
    print(f"memory_allocated above the phase's start after each of 4 publish "
          f"cycles: {[m / 2 ** 20 for m in mem]} MiB; one generation of the "
          f"shards' and the view's device forms {gen / 2 ** 20:.2f} MiB + "
          f"slack {MEM_SLACK / 2 ** 20:.0f} MiB {tag}", flush=True)
    if max(mem) > gen + MEM_SLACK:
        raise AssertionError(f"device memory grew across publish cycles: "
                             f"{mem} bytes against {gen} + {MEM_SLACK}")
    rec["sharded_search_ms"] = search_walls(svc, keys, rng)
    rec["sharded_engines_ms"] = engine_walls(svc, keys, rng)
    print(f"search(left) of {Q_KERNEL} queries over {WRITE_SHARDS} shards: "
          f"{rec['sharded_search_ms'][Q_KERNEL]:.3f} ms host wall, one "
          f"engine call over the view; the {WRITE_SHARDS} shards' own engine "
          f"calls on pre-routed queries take {rec['sharded_engines_ms']:.3f} "
          f"ms {tag}", flush=True)
    del svc
    gc.collect()

    # 3. one shard, dispatch on the cost model's thresholds
    mon = Monitor()
    one = IndexService(keys, error=WRITE_ERROR, buffer_size=WRITE_BUFFER,
                       backend="dispatch", monitor=mon, assume_sorted=True)
    extra = make_inserts(keys, N_ONE, rng)
    for k in extra:
        one.insert(float(k))
    one.publish()
    merged = np.sort(np.concatenate([keys, extra]))
    verbs(one, merged, "one shard, dispatch")
    eng = one.handle.engine("dispatch")
    tiers = {b: eng.tier_for(b) for b in PLAN_BATCHES}
    rec["one_shard_search_ms"] = search_walls(one, keys, rng)
    rec["one_shard_cuda_search_ms"] = search_walls(one, keys, rng, "cuda")
    rec["dispatch"] = {"small_max": eng.small_max,
                       "large_min": eng.large_min, "tiers": tiers}
    print(f"dispatch thresholds from the cost model: small_max "
          f"{eng.small_max}, large_min {eng.large_min}; tiers {tiers}")
    print("search(left) host wall, median of 5, ms at batches "
          f"{list(PLAN_BATCHES)}: {WRITE_SHARDS} shards cuda "
          f"{rec['sharded_search_ms']}, one shard cuda "
          f"{rec['one_shard_cuda_search_ms']}, one shard dispatch "
          f"{rec['one_shard_search_ms']} {tag}", flush=True)

    # 4. the replanner over measured dispatch traffic
    sizes = rng.choice((1, 4, 16, 64, 256, 1024, 4096, 16_384, 65_536), 300)
    for size in sizes:
        one.search(make_queries(keys, int(size), rng))
    rp = Replanner(one)
    before = (eng.small_max, eng.large_min)
    served = rp.replan()
    if rp.last_win is None:
        raise AssertionError("the replanner measured no tier curve")
    after = (before if served is None
             else (served.small_max, served.large_min))
    rec["replan"] = {"before": before, "after": after,
                     "applied": served is not None, "win": rp.last_win,
                     "measured": rp.measured_curves()}
    print(f"replanner over {len(sizes)} dispatch batches: thresholds "
          f"{before} -> {after} (predicted win {rp.last_win:.4f}, "
          f"{'applied' if served else 'below hysteresis, kept'}); measured "
          f"curves {rec['replan']['measured']} {tag}", flush=True)
    verbs(one, merged, "one shard after the replan")
    del one
    gc.collect()
    return rec

# ------------------------------------------------- LSM and the front door
LSM_ERROR, LSM_MEMTABLE, LSM_FANOUT = 64, 4096, 4
LSM_FILLS, LSM_DELETES, LSM_UPSERTS = 63, 4096, 4096
LSM_SCALARS = 16            # probes of the scalar verbs after each step
PIPE_CALLERS, PIPE_REQUESTS, PIPE_MAX_Q = 16, 512, 64
PIPE_WINDOW = 16            # requests each caller keeps in flight
PIPE_WAIT_US = 2000.0       # the coalescing deadline of the pipeline half
OPEN_READERS = 8
OPEN_SPEC = {"error": 64, "write_heavy": True, "insert_rate": 65_536.0,
             "batch_sizes": (2 ** 20,), "hardware": "gpu"}


def live_forms(svc, dev) -> int:
    """Bytes of the LSM's live runs' device forms."""
    return forms_bytes(r.snapshot.table._device_cache.get(dev)
                       for r in svc.level_set.runs)


def check_lsm(svc, live, rng, what):
    """The vector verbs at Q_KERNEL queries and the scalar verbs at
    LSM_SCALARS of them against np.searchsorted on the live multiset."""
    q = make_queries(live, Q_KERNEL, rng)
    n = live.shape[0]
    left = np.searchsorted(live, q, "left")
    right = np.searchsorted(live, q, "right")
    for name, got, want in (("search left", svc.search(q, "left"), left),
                            ("search right", svc.search(q, "right"), right),
                            ("lookup", svc.lookup(q), left)):
        if not np.array_equal(got, want):
            bad = np.flatnonzero(got != want)
            raise AssertionError(f"lsm {what} {name}: {bad.size} mismatches "
                                 f"of {want.size}, first at {bad[:5]}")
    if svc.n_live_keys() != n:
        raise AssertionError(f"lsm {what}: {svc.n_live_keys()} live keys, "
                             f"oracle {n}")
    for i in range(LSM_SCALARS):
        x = float(q[i])
        lo, hi = int(left[i]), int(right[i])
        c_hi = int(np.searchsorted(live, x + 4096, "right"))
        got = tuple((int(p.rank), bool(p.found)) for p in (
            svc.point(x), svc.predecessor(x), svc.successor(x))) + (
            svc.count(x, x + 4096),)
        r = svc.range(x, x + 4096)
        want = ((lo if hi > lo else -1, hi > lo), (hi - 1, hi > 0),
                (lo, lo < n), max(c_hi - lo, 0))
        if got != want or (r.lo_rank, r.hi_rank) != (lo, max(c_hi, lo)) or \
                not np.array_equal(r.keys, live[lo:c_hi]):
            raise AssertionError(f"lsm {what} scalar verbs at {x}: {got} "
                                 f"want {want}")
    print(f"lsm, {what}: search, lookup at {Q_KERNEL} queries and point, "
          f"predecessor, successor, count, range at {LSM_SCALARS} equal "
          f"np.searchsorted on {n} live keys; runs per level "
          f"{svc.level_set.runs_per_level()}", flush=True)


def lsm_memory(torch, svc, dev, base, what, card) -> dict:
    """memory_allocated above ``base`` against the live runs' forms."""
    import gc
    gc.collect()
    torch.cuda.synchronize()
    mem = torch.cuda.memory_allocated() - base
    gen = live_forms(svc, dev)
    print(f"lsm memory {what}: {mem / 2 ** 20:.3f} MiB allocated against one "
          f"generation of the {svc.level_set.n_runs} live runs' device forms "
          f"{gen / 2 ** 20:.3f} MiB + slack {MEM_SLACK / 2 ** 20:.0f} MiB "
          f"[{card}]", flush=True)
    if mem > gen + MEM_SLACK:
        raise AssertionError(f"lsm {what}: {mem} bytes allocated against "
                             f"{gen} + {MEM_SLACK}: a replaced run's device "
                             f"form was kept")
    return {"bytes": mem, "generation_bytes": gen}


def channel_walls(mon, name: str) -> dict:
    """Count, total and median / max wall (ms) of an lsm.* channel, whose
    last column is the wall in ns."""
    rows = mon.channel(name)
    if not rows.size:
        return {"n": 0}
    ms = rows[:, -1] / 1e6
    return {"n": int(rows.shape[0]), "total_ms": float(ms.sum()),
            "median_ms": float(np.median(ms)), "max_ms": float(ms.max())}


def lsm_breakdown(svc, live, rng) -> dict:
    """Where one search(left) of Q_KERNEL queries goes (host wall, median
    of 5 after one warm-up): the whole fan-in, each live run's engine call
    on the whole batch (host arrays in and out, as the fan-in makes them),
    and the runs' shadow corrections (host searchsorted into the newer
    runs' tombstones); the rest is the memtable and the sums."""
    q = make_queries(live, Q_KERNEL, rng)
    runs = svc.level_set.runs
    engines = [r.handle.engine(svc.default_backend) for r in runs]

    def median_wall(fn):
        fn()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            walls.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(walls))

    out = {"runs": len(runs),
           "shadow_keys": [int(r.shadow_keys.size) for r in runs],
           "search_ms": median_wall(lambda: svc.search(q, "left")),
           "engines_ms": median_wall(
               lambda: [e.search(q, "left") for e in engines]),
           "shadows_ms": median_wall(
               lambda: [r.shadow_cum[np.searchsorted(r.shadow_keys, q)]
                        for r in runs if r.shadow_keys.size])}
    out["rest_ms"] = out["search_ms"] - out["engines_ms"] - out["shadows_ms"]
    return out


def lsm_phase(torch, dev, keys, card):
    """Phase 7a: the LSM write plane on the card (module docstring)."""
    import gc
    from repro_torch.index import LsmIndexService
    from repro_torch.index.telemetry import CH_COMPACT, CH_SPILL, Monitor
    rng = np.random.default_rng(SEED + 6)
    tag = f"[{card}]"
    rec = {}
    mon = Monitor(capacity=16_384)
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    svc = LsmIndexService(keys, error=LSM_ERROR, backend="cuda",
                          memtable_capacity=LSM_MEMTABLE,
                          level_fanout=LSM_FANOUT, monitor=mon,
                          assume_sorted=True)
    rec["build_s"] = time.perf_counter() - t0
    if svc.level_set.run_levels() != (6,):
        raise AssertionError(f"the bulk run sits at levels "
                             f"{svc.level_set.run_levels()}, not level 6")
    print(f"lsm: {N_KEYS} keys in one bulk run at level 6, e {LSM_ERROR}, "
          f"memtable {LSM_MEMTABLE}, fanout {LSM_FANOUT}, backend "
          f"{svc.default_backend} ({rec['build_s']:.1f} s)", flush=True)

    ins = make_inserts(keys, LSM_FILLS * LSM_MEMTABLE, rng)
    t0 = time.perf_counter()
    for i in range(LSM_FILLS):
        svc.insert_many(ins[i * LSM_MEMTABLE:(i + 1) * LSM_MEMTABLE])
        svc.publish()                      # spill + one compaction step
    wall = time.perf_counter() - t0
    rec["inserts_per_s"] = ins.shape[0] / wall
    rec["ingest_s"] = wall
    live = np.sort(np.concatenate([keys, ins]))
    rec["runs_after_ingest"] = svc.level_set.runs_per_level()
    rec["search_ms_after_ingest"] = search_walls(svc, live, rng)
    rec["runs_at_walls_after_ingest"] = svc.level_set.n_runs
    rec["breakdown_after_ingest"] = lsm_breakdown(svc, live, rng)
    check_lsm(svc, live, rng, f"after {ins.shape[0]} inserts")
    rec["memory_after_ingest"] = lsm_memory(torch, svc, dev, base,
                                            "after the inserts", card)
    print(f"lsm ingest: {ins.shape[0]} inserts in {LSM_FILLS} fills, each "
          f"followed by publish(): {rec['inserts_per_s']:.0f} inserts a "
          f"second ({wall:.2f} s, spills and compactions included) {tag}",
          flush=True)

    dels = rng.choice(np.unique(live), LSM_DELETES, replace=False)
    for k in dels:
        svc.delete(float(k))
    live = live[~np.isin(live, dels)]
    check_lsm(svc, live, rng, f"after {LSM_DELETES} deletes")
    ups = np.where(rng.random(LSM_UPSERTS) < 0.75,
                   live[rng.integers(0, live.shape[0], LSM_UPSERTS)],
                   rng.integers(0, 2 ** 23, LSM_UPSERTS, endpoint=True)
                   .astype(np.float64))
    for k in ups:
        svc.upsert(float(k))
    live = np.sort(np.concatenate([live[~np.isin(live, ups)],
                                   np.unique(ups)]))
    check_lsm(svc, live, rng, f"after {LSM_UPSERTS} upserts")

    svc.spill()
    t0 = time.perf_counter()
    merged = 0
    while (step := svc.compact(max_steps=4)):
        merged += step
    rec["final_compaction"] = {"runs_merged": merged,
                               "ms": (time.perf_counter() - t0) * 1e3}
    check_lsm(svc, live, rng, "compacted")
    rec["memory_after_compaction"] = lsm_memory(torch, svc, dev, base,
                                                "after the compactions", card)
    m = svc.metrics().lsm
    rec.update(spills=m.spills, compactions=m.compactions,
               runs_per_level=m.run_counts, keys_per_level=m.run_keys,
               read_amplification=m.read_amplification,
               spill_walls=channel_walls(mon, CH_SPILL),
               compaction_walls=channel_walls(mon, CH_COMPACT))
    rec["search_ms"] = search_walls(svc, live, rng)
    rec["runs_at_walls"] = svc.level_set.n_runs
    rec["breakdown"] = lsm_breakdown(svc, live, rng)
    print(f"lsm: {m.spills} spills (lsm.spill: {rec['spill_walls']}), "
          f"{m.compactions} compactions (lsm.compaction: "
          f"{rec['compaction_walls']}); runs per level {m.run_counts}, keys "
          f"per level {m.run_keys}; read amplification (sampled fan-in) "
          f"{m.read_amplification:.2f} {tag}", flush=True)
    print(f"lsm search(left) host wall, median of 5, ms at batches "
          f"{list(PLAN_BATCHES)}: {rec['runs_at_walls_after_ingest']} runs "
          f"after the inserts {rec['search_ms_after_ingest']}, "
          f"{rec['runs_at_walls']} runs compacted {rec['search_ms']} {tag}",
          flush=True)
    for what, b in (("after the inserts", rec["breakdown_after_ingest"]),
                    ("compacted", rec["breakdown"])):
        print(f"lsm breakdown of search(left) at {Q_KERNEL}, {what}, "
              f"{b['runs']} runs: {b['search_ms']:.3f} ms host wall; the "
              f"{b['runs']} engine calls {b['engines_ms']:.3f} ms; the "
              f"shadow corrections {b['shadows_ms']:.3f} ms (shadow keys "
              f"per run {b['shadow_keys']}); the rest {b['rest_ms']:.3f} ms "
              f"{tag}", flush=True)
    del svc
    gc.collect()
    return rec


def make_traffic(keys, rng):
    """PIPE_CALLERS lists of PIPE_REQUESTS (verb, queries, answer): 1 to
    PIPE_MAX_Q queries of the smoke's mix, lookup or search on either side,
    answers from np.searchsorted."""
    n = keys.shape[0]
    traffic = []
    for _ in range(PIPE_CALLERS):
        reqs = []
        for _ in range(PIPE_REQUESTS):
            q = make_queries(keys, int(rng.integers(1, PIPE_MAX_Q + 1)), rng)
            verb = ("lookup", "left", "right")[int(rng.integers(3))]
            left = np.searchsorted(keys, q, "left")
            if verb == "lookup":
                hit = (left < n) & (keys[np.minimum(left, n - 1)] == q)
                want = np.where(hit, left, -1)
            else:
                want = np.searchsorted(keys, q, verb)
            reqs.append((verb, q, want))
        traffic.append(reqs)
    return traffic


def run_callers(traffic, call):
    """One thread per caller list; ``call(verb, q)`` returns the answer or
    a Future.  Returns (wall s, failures)."""
    import threading
    from collections import deque
    failures = []
    barrier = threading.Barrier(len(traffic))

    def caller(reqs):
        pending = deque()

        def settle():
            got, want = pending.popleft()
            got = got.result(120.0) if hasattr(got, "result") else got
            if not np.array_equal(got, want):
                failures.append((got, want))

        try:
            barrier.wait(120.0)
            for verb, q, want in reqs:
                pending.append((call(verb, q), want))
                if len(pending) >= PIPE_WINDOW:
                    settle()
            while pending:
                settle()
        except Exception as exc:    # reported below, the phase fails
            failures.append(exc)

    threads = [threading.Thread(target=caller, args=(r,)) for r in traffic]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600.0)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise AssertionError("a caller thread did not finish in 600 s")
    return wall, failures


def pipeline_phase(torch, dev, keys, card):
    """Phase 7b: the async front door on the card (module docstring)."""
    import gc
    import threading
    from repro_torch.index.fit import FitSpec
    from repro_torch.index.telemetry import CH_SOJOURN, CH_TIER_PREFIX, \
        Monitor
    from repro_torch.kernels.fitting_lookup import fitting_search_cuda
    from repro_torch.serve import AsyncIndexService, IndexService, \
        open_pipeline
    rng = np.random.default_rng(SEED + 7)
    tag = f"[{card}]"
    rec = {}
    traffic = make_traffic(keys, rng)
    n_q = sum(r[1].shape[0] for reqs in traffic for r in reqs)

    # 1. coalescing over a one-shard dispatch service
    mon = Monitor(capacity=4 * PIPE_CALLERS * PIPE_REQUESTS)
    one = IndexService(keys, error=WRITE_ERROR, backend="dispatch",
                       monitor=mon, assume_sorted=True)
    eng = one.handle.engine("dispatch")
    t0 = time.perf_counter()
    pipe = AsyncIndexService(one, flush_threshold=eng.large_min,
                             max_wait_us=PIPE_WAIT_US, prewarm=True)
    rec["prewarm_s"] = time.perf_counter() - t0
    rec["prewarm_launches"] = fitting_search_cuda.launches

    def submit(verb, q):
        if verb == "lookup":
            return pipe.lookup_async(q, timeout=120.0)
        return pipe.search_async(q, verb, timeout=120.0)

    with pipe:
        wall, failures = run_callers(traffic, submit)
        pm = pipe.metrics().pipeline
    if failures:
        raise AssertionError(f"pipeline: {len(failures)} wrong or failed "
                             f"answers, first {failures[0]!r:.300}")
    rec["traffic_launches"] = fitting_search_cuda.launches - \
        rec["prewarm_launches"]
    soj = mon.channel(CH_SOJOURN)[:, 0] / 1e6
    tiers = {}
    for tier in ("small", "medium", "large"):
        rows = mon.channel(CH_TIER_PREFIX + tier)
        if rows.size:
            tiers[tier] = {"calls": int(rows.shape[0]),
                           "median_batch": float(np.median(rows[:, 0])),
                           "median_ms": float(np.median(rows[:, 1])) / 1e6}
    rec["fused_calls_by_tier"] = tiers
    rec.update(queries=n_q, requests=PIPE_CALLERS * PIPE_REQUESTS,
               queries_per_s=n_q / wall, wall_s=wall,
               sojourn_ms={"n": int(soj.size),
                           "p50": float(np.percentile(soj, 50)),
                           "p99": float(np.percentile(soj, 99))},
               flushes={"threshold": pm.threshold_flushes,
                        "deadline": pm.deadline_flushes,
                        "drain": pm.drain_flushes,
                        "inline": pm.inline_batches,
                        "fused_calls": pm.flushes},
               mean_fused_batch=pm.coalesced_queries / max(pm.flushes, 1),
               max_fused_batch=pm.max_fused_batch,
               thresholds={"small_max": eng.small_max,
                           "large_min": eng.large_min})

    def direct(verb, q):
        if verb == "lookup":
            return one.lookup(q)
        return one.search(q, verb)

    d_wall, failures = run_callers(traffic, direct)
    if failures:
        raise AssertionError(f"direct calls: {len(failures)} wrong answers")
    rec["direct_queries_per_s"] = n_q / d_wall
    print(f"pipeline: {PIPE_CALLERS} callers x {PIPE_REQUESTS} requests of 1 "
          f"to {PIPE_MAX_Q} queries ({n_q} queries, up to {PIPE_WINDOW} in "
          f"flight each), every answer equal; flush threshold "
          f"{eng.large_min} (dispatch: numpy <= {eng.small_max}), deadline "
          f"{PIPE_WAIT_US:.0f} us: {rec['queries_per_s']:.0f} queries a "
          f"second; sojourn p50 {rec['sojourn_ms']['p50']:.3f} ms, p99 "
          f"{rec['sojourn_ms']['p99']:.3f} ms; flushes {rec['flushes']}, mean "
          f"fused batch {rec['mean_fused_batch']:.1f} (max "
          f"{pm.max_fused_batch}); fused calls by dispatch tier "
          f"{rec['fused_calls_by_tier']}; fused launches: prewarm "
          f"{rec['prewarm_launches']}, traffic {rec['traffic_launches']}; "
          f"the same traffic calling the service directly (plain, not a "
          f"target) {rec['direct_queries_per_s']:.0f} queries a second "
          f"{tag}", flush=True)
    del pipe, one, eng
    gc.collect()

    # 2. open_pipeline on a write-heavy spec: the cadence compacts under
    # concurrent readers
    t0 = time.perf_counter()
    pipe = open_pipeline(keys, FitSpec(**OPEN_SPEC), assume_sorted=True,
                         monitor=Monitor())
    svc = pipe.service
    rec["open_s"] = time.perf_counter() - t0
    cap = svc.memtable_capacity
    with pipe:
        ins = make_inserts(keys, 16 * cap, rng)
        for i in range(3):         # three L1 runs, merged in the foreground
            svc.insert_many(ins[4 * i * cap:4 * (i + 1) * cap])
            svc.publish()
        svc.insert_many(ins[12 * cap:])  # four more fills, the last unspilled
        live = np.sort(np.concatenate([keys, ins]))
        stop = threading.Event()
        answers, failures = [], []

        def reader(seed):
            r = np.random.default_rng(seed)
            try:
                while not stop.is_set():
                    q = make_queries(live, int(r.integers(1, PIPE_MAX_Q + 1)),
                                     r)
                    verb = ("lookup", "left", "right")[int(r.integers(3))]
                    # the LSM's lookup is its leftmost live rank
                    got = (pipe.lookup(q, 120.0) if verb == "lookup"
                           else pipe.search(q, verb, 120.0))
                    side = "right" if verb == "right" else "left"
                    if not np.array_equal(got, np.searchsorted(live, q,
                                                               side)):
                        failures.append(q)
                    answers.append(q.shape[0])
            except Exception as exc:    # reported below, the phase fails
                failures.append(exc)

        c0 = svc.metrics().lsm.compactions
        readers = [threading.Thread(target=reader, args=(SEED + 100 + i,))
                   for i in range(OPEN_READERS)]
        t0 = time.perf_counter()
        for t in readers:
            t.start()
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline and \
                svc.metrics().lsm.compactions < c0 + 2:
            time.sleep(0.05)
        stop.set()
        for t in readers:
            t.join(120.0)
        read_s = time.perf_counter() - t0
        if any(t.is_alive() for t in readers):
            raise AssertionError("an open_pipeline reader did not finish")
        m = pipe.metrics()
    landed = m.lsm.compactions - c0
    if failures:
        raise AssertionError(f"open_pipeline readers: {len(failures)} wrong "
                             f"or failed answers, first "
                             f"{failures[0]!r:.300}")
    if landed < 1:
        raise AssertionError("no compaction landed while the readers ran")
    rec["open_pipeline"] = {
        "backend": svc.default_backend, "memtable": cap,
        "fanout": svc.level_fanout,
        "publish_interval_s": pipe.publish_interval_s,
        "flush_threshold": pipe.flush_threshold, "inserts": ins.shape[0],
        "compactions_under_readers": landed,
        "cadence_runs_merged": m.pipeline.compactions,
        "maintenance_ticks": m.pipeline.maintenance_ticks,
        "reads": len(answers), "read_queries": int(sum(answers)),
        "read_s": read_s, "runs_per_level": m.lsm.run_counts}
    print(f"open_pipeline (write-heavy spec {OPEN_SPEC}): LsmIndexService on "
          f"{svc.default_backend}, memtable {cap}, fanout "
          f"{svc.level_fanout}, cadence {pipe.publish_interval_s} s; "
          f"{ins.shape[0]} inserts, then {OPEN_READERS} readers made "
          f"{len(answers)} requests in {read_s:.2f} s, every answer equal, "
          f"while {landed} compactions landed (the cadence merged "
          f"{m.pipeline.compactions} runs in {m.pipeline.maintenance_ticks} "
          f"ticks); runs per "
          f"level {m.lsm.run_counts} {tag}", flush=True)
    del pipe, svc
    gc.collect()
    return rec

# ------------------------------------------------- the device-sharded plane
PLANE_ROWS, PLANE_EXCHANGES = 4, ("allgather", "a2a", "auto")
# Row capacity over the largest shard: at the default 0.5 one shard's
# re-fit after N_HOT inserts outgrows its row's segment capacity, which
# makes that publish a full one.
PLANE_HEADROOM = 1.0
PLANE_SKEW = 2 ** 16        # queries of the skewed a2a batch


class _Verbs:
    """``check_verbs``'s verb surface for a service whose verbs take no
    ``backend``."""

    def __init__(self, svc):
        self.svc = svc

    def __getattr__(self, name):
        fn = getattr(self.svc, name)
        return lambda *args, backend=None, **kw: fn(*args, **kw)


def row_ptrs(ds) -> list[list[int]]:
    """Each row's five tensors' storage addresses."""
    from repro_torch.index.device_plane import _ROW_FIELDS
    return [[getattr(ds, f)[r].data_ptr() for f in _ROW_FIELDS]
            for r in range(ds.n_devices)]


def set_bytes(ds) -> int:
    """Device bytes of a manifest: every row tensor and every replica."""
    from repro_torch.index.device_plane import _ROW_FIELDS
    tensors = [t for f in (*_ROW_FIELDS, "d_offsets", "d_boundaries")
               for t in getattr(ds, f)]
    return sum(t.numel() * t.element_size() for t in tensors)


def device_plane_phase(torch, dev, keys, card, sharded_ms):
    """Phase 8: ``DeviceShardedService`` with four rows on the card (see the
    module docstring)."""
    import gc
    from repro_torch.index import DeviceShardedService
    rng = np.random.default_rng(SEED + 7)
    tag = f"[{card}]"
    rec = {"rows": PLANE_ROWS, "error": WRITE_ERROR,
           "buffer_size": WRITE_BUFFER, "headroom": PLANE_HEADROOM}
    k32 = keys.astype(np.float32)
    mem_base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    svc = DeviceShardedService(
        keys, error=WRITE_ERROR, device_count=PLANE_ROWS,
        devices=[str(dev)] * PLANE_ROWS, buffer_size=WRITE_BUFFER,
        headroom=PLANE_HEADROOM, assume_sorted=True)
    rec["build_s"] = time.perf_counter() - t0
    ds = svc.device_set
    print(f"device plane: {PLANE_ROWS} rows on {dev}, s_cap {ds.s_cap}, "
          f"m_cap {ds.m_cap}, live keys {list(ds.n_local)}, built in "
          f"{rec['build_s']:.1f} s", flush=True)

    # every verb on every exchange at each batch size, and the walls
    walls = {}
    for xchg in PLANE_EXCHANGES:
        svc.exchange = xchg
        walls[xchg] = {}
        for size in BATCHES:
            q = make_queries(keys, size, rng)
            check_verbs(_Verbs(svc), f"device plane {xchg}", keys, k32, q,
                        rng)
            svc.search(q, "left")
            ws = []
            for _ in range(5):
                t1 = time.perf_counter()
                svc.search(q, "left")
                ws.append((time.perf_counter() - t1) * 1e3)
            walls[xchg][size] = float(np.median(ws))
        print(f"device plane {xchg}: every verb at {list(BATCHES)} equals "
              f"np.searchsorted; search(left) host wall, median of 5, ms "
              f"{walls[xchg]} {tag}", flush=True)
    rec["search_ms"] = walls
    dm = svc.metrics().device
    rec["calls"] = {"allgather": dm.allgather_calls, "a2a": dm.a2a_calls}
    svc.exchange = "allgather"

    # one row's publish: that row's tensors alone change, and the bytes
    d = 1
    lo = int(np.ceil(svc.boundaries[d]))
    hi = int(svc.boundaries[d + 1]) - 1
    hot = make_inserts(keys, N_HOT, rng, lo, hi)
    before, n0 = row_ptrs(svc.device_set), svc.device_set.n_local
    m0 = svc.metrics().device
    for k in hot:
        svc.insert(float(k))
    t0 = time.perf_counter()
    published = svc.publish()
    rec["publish_ms"] = (time.perf_counter() - t0) * 1e3
    ds = svc.device_set
    after, m1 = row_ptrs(ds), svc.metrics().device
    changed = [r for r in range(PLANE_ROWS) if after[r] != before[r]]
    kept = [r for r in range(PLANE_ROWS) if after[r] == before[r]]
    whole = [r for r in changed
             if all(a != b for a, b in zip(after[r], before[r]))]
    up = m1.bytes_uploaded - m0.bytes_uploaded
    want_up = ds.row_bytes() + ds.replicated_bytes() * PLANE_ROWS
    if sorted(published) != [d] or changed != [d] or whole != [d] or \
            len(kept) != PLANE_ROWS - 1 or up != want_up or \
            m1.delta_publishes != m0.delta_publishes + 1 or \
            ds.n_local[d] != n0[d] + N_HOT:
        raise AssertionError(f"device plane publish: published "
                             f"{sorted(published)}, rows changed {changed}, "
                             f"kept {kept}, {up} bytes against {want_up}")
    merged = np.sort(np.concatenate([keys, hot]))
    m32 = merged.astype(np.float32)
    check_verbs(_Verbs(svc), "device plane after a publish", merged, m32,
                make_queries(merged, Q_KERNEL, rng), rng)
    rec["delta"] = {"row": d, "inserts": N_HOT, "bytes": up,
                    "row_bytes": ds.row_bytes(),
                    "replicated_bytes": ds.replicated_bytes(),
                    "full_bytes": m1.bytes_full_equivalent
                    - m0.bytes_full_equivalent}
    print(f"device plane: {N_HOT} inserts into row {d} [{lo}, {hi}], publish "
          f"{rec['publish_ms']:.1f} ms; only row {d}'s tensors changed (rows "
          f"{kept} kept their data_ptr); {up} bytes uploaded = row_bytes "
          f"{ds.row_bytes()} + {PLANE_ROWS} x replicated "
          f"{ds.replicated_bytes()} (a full publish: "
          f"{rec['delta']['full_bytes']}) {tag}", flush=True)

    # a skewed a2a batch at slack 1: exact, with overflow
    svc.exchange, svc.slack = "a2a", 1.0
    skew = np.full(PLANE_SKEW, merged[0])
    got = svc.search(skew, "left")
    if not np.array_equal(got, np.searchsorted(m32, skew.astype(np.float32),
                                               "left")):
        raise AssertionError("device plane: the skewed a2a batch is wrong")
    over = svc.metrics().device.a2a_overflow_queries - \
        m1.a2a_overflow_queries
    if over <= 0:
        raise AssertionError("device plane: the skewed batch did not "
                             "overflow slack 1")
    rec["skew_overflow_queries"] = over
    svc.exchange, svc.slack = "allgather", 2.0
    print(f"device plane a2a at slack 1: {PLANE_SKEW} queries owned by row "
          f"0 answered exactly, {over} overflowed into the allgather pass",
          flush=True)

    # a rebalance is a full publish
    m2 = svc.metrics().device
    info = svc.rebalance(force=True)
    m3 = svc.metrics().device
    if info is None or m3.full_publishes != m2.full_publishes + 1:
        raise AssertionError(f"device plane rebalance: {info}, full "
                             f"publishes {m2.full_publishes} -> "
                             f"{m3.full_publishes}")
    check_verbs(_Verbs(svc), "device plane after a rebalance", merged, m32,
                make_queries(merged, Q_KERNEL, rng), rng)
    print(f"device plane rebalance: {info}; a full publish, live keys "
          f"{list(svc.device_set.n_local)} {tag}", flush=True)
    del ds, before, after
    gc.collect()
    torch.cuda.synchronize()
    mem = torch.cuda.memory_allocated() - mem_base
    gen = set_bytes(svc.device_set)
    rec["memory"] = {"bytes": mem, "generation_bytes": gen}
    print(f"device plane memory: {mem / 2 ** 20:.3f} MiB allocated against "
          f"one generation of the rows {gen / 2 ** 20:.3f} MiB + slack "
          f"{MEM_SLACK / 2 ** 20:.0f} MiB {tag}", flush=True)
    if mem > gen + MEM_SLACK:
        raise AssertionError(f"device plane: {mem} bytes against {gen} + "
                             f"{MEM_SLACK}: a replaced row was kept")
    m = svc.metrics().device
    rec["metrics"] = {k: getattr(m, k) for k in (
        "publishes", "delta_publishes", "full_publishes", "bytes_uploaded",
        "bytes_full_equivalent", "delta_fraction", "allgather_calls",
        "a2a_calls", "a2a_overflow_queries")}
    print("search(left) host wall, median of 5, ms at batches "
          f"{list(BATCHES)}: device plane {PLANE_ROWS} rows "
          + ", ".join(f"{x} {walls[x]}" for x in PLANE_EXCHANGES)
          + f"; phase 6's {WRITE_SHARDS}-shard ShardedIndexService at "
          f"{Q_KERNEL}: {sharded_ms:.3f} {tag}", flush=True)
    del svc
    gc.collect()
    return rec

# ------------------------------------------------------------ LM serving
ARCH = "recurrentgemma-9b"
BF16_OPS = 989e12          # H100 SXM dense bf16/fp16 tensor-core op/s
# flash cases: (name, B, H, Hkv, Tq, S, hd, dtype, options)
FLASH_CASES = (
    ("local prefill", 1, 16, 1, 4096, 4096, 256, "bfloat16",
     {"causal": True, "window": 2048}),
    ("softcap gqa", 1, 8, 4, 2048, 2048, 128, "float32",
     {"causal": True, "softcap": 50.0}),
    ("non-causal", 2, 8, 2, 1024, 1024, 64, "float32", {"causal": False}),
    ("decode query", 4, 16, 1, 1, 4096, 256, "bfloat16",
     {"causal": True, "window": 2048}),
    ("local prefill hd 128", 1, 16, 1, 4096, 4096, 128, "bfloat16",
     {"causal": True, "window": 2048}),
    ("non-causal hd 64", 2, 8, 2, 1024, 1024, 64, "bfloat16",
     {"causal": False}),
    # the attention families' shapes: whisper-medium's encoder over its
    # 1,500 frames; llama-3.2-vision's cross layers, a 4,096-token prompt
    # over 1,600 patches (Tq > S: q_offset = S - Tq < 0); gemma2-27b's
    # global layers with their soft-cap
    ("whisper encoder", 2, 16, 16, 1500, 1500, 64, "bfloat16",
     {"causal": False}),
    ("vision cross", 1, 32, 8, 4096, 1600, 128, "bfloat16",
     {"causal": False}),
    ("gemma2 global", 1, 32, 16, 4096, 4096, 128, "bfloat16",
     {"causal": True, "softcap": 50.0}),
    # the same without the soft-cap: what the cap itself costs
    ("gemma2 global no cap", 1, 32, 16, 4096, 4096, 128, "bfloat16",
     {"causal": True}),
)
# The reference's own bounds for a blocked against a dense softmax
# (tests/test_kernels_extra.py): both accumulate in f32, in another order.
FLASH_TOL = {"bfloat16": 2e-2, "float32": 2e-4}
# The scan: (name, B, T, W, h0).  Both paths round each step's product and
# sum as the twin's separate multiply and add do, in time order, so each
# case must equal the twin exactly (max abs err 0).
RGLRU_CASES = (
    ("headline", 4, 4096, 4096, True),
    ("batcher prefill", 1, 3072, 4096, True),   # admission is at batch 1
    ("ragged", 2, 1000, 96, False),             # T not a tile multiple
    ("ragged width", 2, 1000, 100, True),       # nor W: a partial box
    ("unaligned", 1, 37, 130, True),            # W % 4 != 0: no TMA
)
RGLRU_DESIGN = ("tma path: one producer warp keeps TMA loads of (64 x 32) "
                "a and u tiles in a 3-stage shared-memory ring, one consumer "
                "warp copies a tile to registers and steps its 32 channels "
                "in time order with h in a register, h tiles TMA-stored from "
                "shared memory; unaligned path (W % 4 != 0, unaligned base, "
                "T = 0): one thread a channel, 16 steps' loads ahead")
# Phase 10: full width, depth cut to one unit + one tail layer, f32.
CONSIST_STACKS = ((("rglru", "rglru", "local"), 1), (("rglru",), 1))
CONSIST_B, CONSIST_T_PRE, CONSIST_T_DEC = 2, 2304, 16
CONSIST_TOL = 3e-2         # rtol = atol, tests/test_multistep_decode.py
# Phase 11: full width and depth, bf16.
PREFILL_B, PREFILL_T = 4, 4096
N_SLOTS, CACHE_LEN, N_REQUESTS, MAX_NEW = 4, 4160, 8, 16
PROMPT_LENS = (256, 3072)
# Phase 10b: the attention families at full width, each unit (and encoder
# unit) repeated once, f32: (arch, prefill tokens).  The prefill passes each
# local window (gemma3 1,024, gemma2 4,096) so decode wraps the rings; the
# MoE prompts stay short, as the dispatch buffer is E x capacity x D.
ARCH_CONSIST = (("gemma3-12b", 1040), ("internlm2-1.8b", 256),
                ("gemma2-27b", 4112), ("minicpm-2b", 256),
                ("arctic-480b", 64), ("qwen3-moe-235b-a22b", 64),
                ("llama-3.2-vision-11b", 256), ("whisper-medium", 64),
                ("xlstm-350m", 300))
# Phase 11b: the attention families served in bf16 at full width: (arch,
# repeats kept where one card or the smoke's time forces a depth cut:
# xlstm-350m's host-bound loops took 270 of the phase's 357 s at its full 6
# repeats (PR 19 c13), so it serves 2).  The two MoE models keep
# bf16 caches: with f32 caches decode would promote each layer's whole
# expert tensors to f32 (17.8 GB for one of arctic's).
ARCH_SERVE = (("gemma3-12b", None), ("internlm2-1.8b", None),
              ("gemma2-27b", None), ("minicpm-2b", None),
              ("qwen3-moe-235b-a22b", 11), ("arctic-480b", 2),
              ("llama-3.2-vision-11b", None), ("whisper-medium", None),
              ("xlstm-350m", 2))
ARCH_PREFILL_T = {"whisper-medium": 448}   # whisper's decoder context
ARCH_CACHE_LEN, ARCH_PROMPTS = 1056, (128, 1024)
# The MoE layer's torch ops, by the profiler's self device time of the aten
# ops that launch them: the expert products (the only batched products of a
# prefill) and the router's top-k, the dispatch (sort, searchsorted, gather,
# scatter) and the combine (index_add_).  The scatter also holds the caches'
# ring writes, which are index_put_ too.
MOE_OPS = (("expert products", ("aten::bmm",)),
           ("top-k", ("aten::topk",)),
           ("sort", ("aten::sort",)),
           ("searchsorted", ("aten::searchsorted",)),
           ("gather", ("aten::index",)),
           ("scatter", ("aten::index_put_", "aten::_index_put_impl_")),
           ("combine", ("aten::index_add_",)))


def flash_check(torch, name, q, k, v, kw):
    """One launch of the flash kernel against its twin on the same inputs:
    every element within FLASH_TOL (relative and absolute) and the block
    relative error within BLOCK_REL_TOL, else AssertionError.  Returns
    (max abs err, tol, block relative error, its limit)."""
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_torch)
    from repro_torch.kernels.ref import BLOCK_REL_TOL, block_rel_err
    got = flash_attention_cuda(q, k, v, **kw)
    want = flash_attention_torch(q, k, v, **kw)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    tol = FLASH_TOL[str(q.dtype)[6:]]
    bad = (got.float() - want.float()).abs() > tol + tol * want.float().abs()
    rel, rel_tol = block_rel_err(got, want), BLOCK_REL_TOL[q.dtype]
    if bool(bad.any()) or rel > rel_tol or \
            not bool(torch.isfinite(got).all()):
        raise AssertionError(f"flash {name}: kernel != plain twin "
                             f"(max abs err {err}, {int(bad.sum())} "
                             f"elements outside {tol}; block relative "
                             f"error {rel} against {rel_tol})")
    return err, tol, rel, rel_tol


@contextlib.contextmanager
def recording_flash(seen: dict):
    """While open, every flash call the model makes (through
    ``blocks.flash_attention``) goes on as before, and the first call of
    each distinct (dtype, hd, H, Hkv, Tq, S, causal, window, softcap) keeps
    a copy of its batch-0 q, k and v, strides kept, in ``seen``."""
    from repro_torch.models import blocks
    inner = blocks.flash_attention

    def record(q, k, v, **kw):
        key = (str(q.dtype)[6:], q.shape[3], q.shape[1], k.shape[1],
               q.shape[2], k.shape[2], kw["causal"], kw["window"],
               kw["softcap"])
        if key not in seen:
            seen[key] = (q[:1].clone(), k[:1].clone(), v[:1].clone(), kw)
        return inner(q, k, v, **kw)

    blocks.flash_attention = record
    try:
        yield seen
    finally:
        blocks.flash_attention = inner


def flash_vs_plain(torch, dev):
    """Phase 9: the flash kernel against its twin and SDPA."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_torch,
                                                     kernel_path)
    cases = []
    for name, b, h, hkv, tq, s, hd, dt, kw in FLASH_CASES:
        dtype = getattr(torch, dt)
        g = torch.Generator(device=dev).manual_seed(SEED + tq + hd)
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
                   for shape in ((b, h, tq, hd), (b, hkv, s, hd),
                                 (b, hkv, s, hd)))
        err, tol, rel, rel_tol = flash_check(torch, name, q, k, v, kw)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        bound, bound_by, ops = flash_bound(torch, dev, b, h, tq, s, hd,
                                           dtype, kw, nbytes)
        ms = median_ms(torch, lambda: flash_attention_cuda(q, k, v, **kw))
        plain_ms = median_ms(torch, lambda: flash_attention_torch(q, k, v,
                                                                  **kw))
        lib_ms = None
        if "softcap" not in kw:
            kx, vx = (t[:, :, None].expand(b, hkv, h // hkv, s, hd)
                      .reshape(b, h, s, hd) for t in (k, v))
            mask = flash_mask(torch, dev, tq, s, kw)
            lib_ms = median_ms(torch, lambda: F.scaled_dot_product_attention(
                q, kx, vx, attn_mask=mask))
        path = kernel_path(dtype, hd)
        cases.append({"case": name, "path": path, "b": b, "h": h, "hkv": hkv,
                      "tq": tq, "s": s, "hd": hd, "dtype": dt, **kw,
                      "tol": tol, "block_rel_err": rel,
                      "block_rel_tol": rel_tol, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "library_ms": lib_ms, "bound_ms": bound,
                      "bound_by": bound_by, "flop": ops, "bytes": nbytes})
        lib = "none (softcap)" if lib_ms is None else f"{lib_ms:.4f} ms"
        print(f"flash {name} ({path}): B={b} H={h} Hkv={hkv} Tq={tq} S={s} "
              f"hd={hd} {dt} {kw}: within {tol} (max abs err {err:.3g}) "
              f"and block relative error {rel:.3g} <= {rel_tol}; "
              f"kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib}, bound "
              f"{bound:.4f} ms ({ops / 1e9:.1f} GFLOP)",
              flush=True)
    return cases


# Phase 9c: flash at the per-rank heads of each attention family under a
# 16-way model axis (models/tensor_parallel.py): H / 16 q heads, over Hkv /
# 16 kv heads where those divide (case A) or the kv heads the rank's q heads
# group into (case B); where H does not divide (minicpm-2b's 36, arctic's
# 56: case C) the heads rank 0's columns touch after the halo exchange
# (minicpm 3 over 3 at hd 64, arctic 4 over 1 at hd 128) over the kv heads
# those group into; each layer kind's mask at B 1, T = S = 4,096, bf16,
# beside the whole-head call on the same card.
FLASH_TP = 16
FLASH_TP_T = 4096
FLASH_TP_ARCHS = ("recurrentgemma-9b", "internlm2-1.8b", "gemma3-12b",
                  "gemma2-27b", "qwen3-moe-235b-a22b",
                  "llama-3.2-vision-11b", "whisper-medium", "minicpm-2b",
                  "arctic-480b")


def tp_heads(cfg, tp: int) -> tuple[int, int]:
    """(q heads, kv heads) of rank 0's flash call under ``tp`` model ranks,
    as ``blocks.attention_heads`` splits them under ``param_spec``'s
    placements: its q heads (A, B) or the heads its q columns touch (C),
    over the kv heads those group into."""
    from repro_torch.models import blocks
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    heads = blocks._heads(h, kv, hd, tp, 0, h * hd % tp == 0,
                          kv * hd % tp == 0)
    return heads.nq, len({j // (h // kv) for j in
                          range(heads.q0, heads.q0 + heads.nq)})


def tp_layer_kinds(cfg) -> list[tuple[str, dict]]:
    """Each distinct attention mask of ``cfg``'s layers: (kind, options)."""
    kinds = {b for unit, _ in cfg.stacks for b in unit}
    cap = {"softcap": cfg.attn_softcap} if cfg.attn_softcap else {}
    out = []
    if "local" in kinds:
        out.append(("local", {"causal": True, "window": cfg.window, **cap}))
    if kinds & {"attn", "moe", "self+cross"}:
        out.append(("global", {"causal": True, **cap}))
    if kinds & {"cross", "self+cross"}:
        out.append(("cross", {"causal": False, **cap}))
    if cfg.encoder_stacks:
        out.append(("encoder", {"causal": False, **cap}))
    return out


def flash_mask(torch, dev, tq, s, kw):
    """The (Tq, S) mask of flash's options, queries end-aligned."""
    qpos = torch.arange(tq, device=dev)[:, None] + (s - tq)
    kpos = torch.arange(s, device=dev)[None, :]
    mask = torch.ones((tq, s), dtype=torch.bool, device=dev)
    if kw.get("causal", True):
        mask &= kpos <= qpos
    if kw.get("window"):
        mask &= kpos > qpos - kw["window"]
    return mask


def flash_bound(torch, dev, b, h, tq, s, hd, dtype, kw, nbytes):
    """(bound ms, what bounds it, FLOPs): the visible (query, key) pairs'
    4 hd FLOPs each at the card's peak for ``dtype``, or ``nbytes`` at its
    memory rate, whichever takes longer."""
    ops = 4 * hd * int(flash_mask(torch, dev, tq, s, kw).sum()) * b * h
    op_ms = ops / (BF16_OPS if dtype != torch.float32 else F32_OPS) * 1e3
    byte_ms = nbytes / HBM_BPS * 1e3
    return (max(op_ms, byte_ms), "operations" if op_ms >= byte_ms
            else "bytes", ops)


def flash_tp_shapes(torch, dev, card) -> list[dict]:
    """Phase 9c: FLASH_TP_ARCHS' per-rank flash calls against the twin, and
    their card time beside the whole-head call's and, without a soft-cap,
    SDPA's on the same inputs (the kv heads expanded to the q heads, the
    same boolean mask)."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_torch)
    out = []
    t = FLASH_TP_T
    for arch in FLASH_TP_ARCHS:
        cfg = get_config(arch)
        nq, nkv = tp_heads(cfg, FLASH_TP)
        hd = cfg.hd
        for kind, kw in tp_layer_kinds(cfg):
            kw = {"window": None, "softcap": None, **kw,
                  "scale": hd ** -0.5}
            g = torch.Generator(device=dev).manual_seed(SEED + nq + hd)
            q, k, v = (torch.randn(shape, generator=g, device=dev)
                       .to(torch.bfloat16)
                       for shape in ((1, nq, t, hd), (1, nkv, t, hd),
                                     (1, nkv, t, hd)))
            name = f"{arch} {kind} tp{FLASH_TP}"
            err, tol, rel, rel_tol = flash_check(torch, name, q, k, v, kw)
            ms = median_ms(torch, lambda: flash_attention_cuda(q, k, v, **kw))
            plain_ms = median_ms(torch, lambda: flash_attention_torch(
                q, k, v, **kw), reps=5)
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
            bound, by, ops = flash_bound(torch, dev, 1, nq, t, t, hd,
                                         q.dtype, kw, nbytes)
            qw, kw_, vw = (torch.randn(shape, generator=g, device=dev)
                           .to(torch.bfloat16)
                           for shape in ((1, cfg.n_heads, t, hd),
                                         (1, cfg.n_kv_heads, t, hd),
                                         (1, cfg.n_kv_heads, t, hd)))
            whole_ms = median_ms(torch, lambda: flash_attention_cuda(
                qw, kw_, vw, **kw))
            del qw, kw_, vw
            lib_ms = None
            if not kw["softcap"]:
                kx, vx = (x[:, :, None].expand(1, nkv, nq // nkv, t, hd)
                          .reshape(1, nq, t, hd) for x in (k, v))
                mask = flash_mask(torch, dev, t, t, kw)
                lib_ms = median_ms(torch, lambda: F.scaled_dot_product_attention(
                    q, kx, vx, attn_mask=mask, scale=kw["scale"]))
                del kx, vx, mask
            opts = {k: kw[k] for k in ("causal", "window", "softcap")}
            out.append({"arch": arch, "layer": kind, "q_heads": nq,
                        "kv_heads": nkv, "whole_q_heads": cfg.n_heads,
                        "whole_kv_heads": cfg.n_kv_heads, "hd": hd,
                        "t": t, **opts, "max_abs_err": err, "tol": tol,
                        "block_rel_err": rel, "ms": ms,
                        "plain_ms": plain_ms, "library_ms": lib_ms,
                        "bound_ms": bound, "bound_by": by, "flop": ops,
                        "whole_ms": whole_ms, "whole_over_tp": whole_ms / ms})
            lib = "none (soft-cap)" if lib_ms is None else \
                f"{lib_ms:.4f} ms"
            print(f"flash {name}: {nq} / {nkv} heads of {cfg.n_heads} / "
                  f"{cfg.n_kv_heads}, hd {hd}, T = S = {t}, bf16 {opts}: "
                  f"within {tol} (max abs err {err:.3g}, block relative "
                  f"error {rel:.3g} <= {rel_tol}); kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, sdpa {lib}, bound {bound:.4f} ms "
                  f"({100 * bound / ms:.0f} %), whole-head call "
                  f"{whole_ms:.4f} ms ({whole_ms / ms:.2f}x) [{card}]",
                  flush=True)
    return out


# Phase 9d: the RG-LRU scan at a rank's channels under a 16-way model axis
# (blocks.apply_rglru splits recurrentgemma-9b's W = 4,096 into 256 a rank):
# (direction, name, B, T, W, h0), the rank's rows of each cell's batch over
# data 16 (prefill_32k 32 -> 2, train_4k 256 -> 16), each beside the
# whole-width call on the same card.
RGLRU_TP = 16
RGLRU_TP_SHAPES = (
    ("forward", "headline", 4, 4096, 4096, True),
    ("forward", "prefill_32k rank", 2, 32768, 4096, False),
    ("backward", "training", 2, 2048, 4096, False),
    ("backward", "train_4k rank", 16, 4096, 4096, False))


def rglru_tp_shapes(torch, dev, card) -> list[dict]:
    """Phase 9d: the scan's forward and backward kernels at RGLRU_TP_SHAPES'
    per-rank width W / RGLRU_TP, each ``torch.equal`` to its twin on the
    card, its path, its CUDA-event ms beside its bound and the twin's, and
    the whole-width call's ms on the same card."""
    from repro_torch.kernels.rglru_scan import (rglru_scan_backward_cuda,
                                                rglru_scan_backward_torch,
                                                rglru_scan_cuda,
                                                rglru_scan_torch, scan_path)
    out = []
    for i, (way, name, b, t, w, with_h0) in enumerate(RGLRU_TP_SHAPES):
        wl = w // RGLRU_TP
        gen = torch.Generator(device=dev).manual_seed(SEED + 31 + i)

        def inputs(width):
            u = torch.randn((b, t, width), generator=gen, device=dev)
            a = torch.rand((b, t, width), generator=gen, device=dev)
            h0 = torch.randn((b, width), generator=gen, device=dev) \
                if with_h0 else None
            if way == "forward":
                return (u, a, h0)
            g = torch.randn((b, t, width), generator=gen, device=dev)
            return (g, a, rglru_scan_cuda(u, a)[0])

        args = inputs(wl)
        kernel, twin = (rglru_scan_cuda, rglru_scan_torch) if way == \
            "forward" else (rglru_scan_backward_cuda,
                            rglru_scan_backward_torch)
        path = scan_path(*args[:2]) if way == "forward" else scan_path(*args)
        got, want = kernel(*args), twin(*args)
        torch.cuda.synchronize()
        err = max(float((x - y).abs().max()) for x, y in zip(got, want))
        if not all(map(torch.equal, got, want)):
            raise AssertionError(f"rglru {way} tp{RGLRU_TP} {name}: kernel "
                                 f"({path}) != twin (max abs err {err})")
        del got, want
        ms = median_ms(torch, lambda: kernel(*args))
        plain_ms = median_ms(torch, lambda: twin(*args), reps=3, warmup=1)
        n = b * t * wl
        if way == "forward":
            nbytes, ops = (3 * n + (2 if with_h0 else 1) * b * wl) * 4, 2 * n
        else:
            nbytes, ops = 5 * n * 4, 3 * n
        byte_ms, op_ms = nbytes / HBM_BPS * 1e3, ops / F32_OPS * 1e3
        bound = max(byte_ms, op_ms)
        del args
        whole = inputs(w)
        whole_ms = median_ms(torch, lambda: kernel(*whole))
        del whole
        torch.cuda.empty_cache()
        res = {"direction": way, "case": name, "b": b, "t": t, "w": wl,
               "whole_w": w, "h0": with_h0, "path": path,
               "max_abs_err": err, "equal": True, "ms": ms,
               "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound,
               "bound_by": "bytes" if byte_ms >= op_ms else "operations",
               "bytes": nbytes, "share": bound / ms, "whole_ms": whole_ms,
               "whole_over_tp": whole_ms / ms}
        out.append(res)
        print(f"rglru {way} tp{RGLRU_TP} {name}: B={b} T={t} W={wl} of {w} "
              f"f32 {'with' if with_h0 else 'no'} h0: path {path}, "
              f"torch.equal to the twin; kernel {ms:.4f} ms, plain (the "
              f"twin's loop) {plain_ms:.2f} ms, library none, bound "
              f"{bound:.4f} ms ({res['bound_by']}: {nbytes} bytes), "
              f"{res['share']:.1%} of bound; whole-width call {whole_ms:.4f} "
              f"ms ({whole_ms / ms:.2f}x) [{card}]", flush=True)
    return out


def rglru_vs_plain(torch, dev):
    """Phase 9: the RG-LRU scan kernels against the twin at RGLRU_CASES,
    each beside the unaligned kernel (the first design) on the same input."""
    from repro_torch.kernels.rglru_scan import (_rglru_scan_launch,
                                                rglru_scan_cuda,
                                                rglru_scan_torch, scan_path)
    cases = []
    for i, (name, b, t, w, with_h0) in enumerate(RGLRU_CASES):
        g = torch.Generator(device=dev).manual_seed(SEED + 5 + i)
        u = torch.randn((b, t, w), generator=g, device=dev)
        a = torch.rand((b, t, w), generator=g, device=dev)
        h0 = torch.randn((b, w), generator=g, device=dev) if with_h0 \
            else None
        path = scan_path(u, a)
        got, got_last = rglru_scan_cuda(u, a, h0)
        want, want_last = rglru_scan_torch(u, a, h0)
        torch.cuda.synchronize()
        err = max(float((got - want).abs().max()),
                  float((got_last - want_last).abs().max()))
        if err != 0 or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"rglru {name}: kernel ({path}) != plain "
                                 f"twin (max abs err {err})")
        nbytes = (3 * b * t * w + (2 if with_h0 else 1) * b * w) * 4
        ops = 2 * b * t * w
        byte_ms, op_ms = nbytes / HBM_BPS * 1e3, ops / F32_OPS * 1e3
        def new(u=u, a=a, h0=h0):
            return rglru_scan_cuda(u, a, h0)

        def old(u=u, a=a, h0=h0):
            return _rglru_scan_launch(u, a, h0, "unaligned")

        ms, old_ms = median_ms(torch, new), median_ms(torch, old)
        b_ms, old_b_ms = burst_ms(torch, new), burst_ms(torch, old)
        launch_us = host_us(torch, new)
        prof = one_call_profile(torch, new, "rglru_scan")
        plain_ms = median_ms(torch, lambda: rglru_scan_torch(u, a, h0),
                             reps=5, warmup=1)
        bound = max(byte_ms, op_ms)
        case = {"case": name, "b": b, "t": t, "w": w, "h0": with_h0,
                "path": path, "max_abs_err": err, "exact": True, "ms": ms,
                "burst_ms": b_ms, "host_us": launch_us,
                "unaligned_ms": old_ms, "unaligned_burst_ms": old_b_ms,
                "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound,
                "bound_by": "bytes" if byte_ms >= op_ms else "operations",
                "share": bound / ms, "burst_share": bound / b_ms,
                "bytes": nbytes, "one_call_profile": prof}
        cases.append(case)
        print(f"rglru {name} B={b} T={t} W={w} f32 "
              f"{'with' if with_h0 else 'no'} h0: path {path}, max abs err "
              f"0 (bit-exact); kernel {ms:.4f} ms one call ({b_ms:.4f} ms "
              f"a call in bursts of 20; launch path {launch_us:.1f} us "
              f"host wall), unaligned kernel (first design) {old_ms:.4f} ms "
              f"({old_b_ms:.4f} in bursts), plain (loop over T) "
              f"{plain_ms:.2f} ms, library none, bound {bound:.4f} ms "
              f"({case['bound_by']}), {case['share']:.1%} of bound "
              f"({case['burst_share']:.1%} in bursts)", flush=True)
        if prof["recorded"]:
            print(f"rglru {name} one call under the profiler "
                  f"({prof['recorded']} of {prof['reps']} calls recorded): "
                  f"events {prof['event_ms']:.4f} ms = kernel "
                  f"{prof['kernel_ms']:.4f} ms + "
                  f"{prof['outside_kernel_ms'] * 1e3:.1f} us outside it; "
                  f"host span {prof['host_span_us']:.1f} us, from its "
                  f"start to cudaLaunchKernel "
                  f"{fmt_us(prof['to_launch_us'])} us and to the kernel's "
                  f"start {prof['to_kernel_us']:.1f} us", flush=True)
        else:
            print(f"rglru {name} one call under the profiler: no call's "
                  f"kernel recorded, not measured", flush=True)
    return cases


def lm_consistency(torch, dev):
    """Phase 10: teacher-forced prefill + decode == a cache-free forward,
    at full width in f32, depth cut to CONSIST_STACKS."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import (decode_step, forward, init_caches,
                                    init_params, prefill)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(ARCH), stacks=CONSIST_STACKS)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, dtype=torch.float32, device=dev)
    n = CONSIST_T_PRE + CONSIST_T_DEC
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    toks = torch.randint(0, cfg.vocab, (CONSIST_B, n), generator=g,
                         device=dev, dtype=torch.int32)
    ref, _ = forward(params, cfg, toks)
    ref = ref[:, CONSIST_T_PRE:].clone()
    caches = init_caches(cfg, CONSIST_B, n, dtype=torch.float32, device=dev)
    _, caches = prefill(params, cfg, toks[:, :CONSIST_T_PRE], caches,
                        last_only=True)
    worst = 0.0
    for i in range(CONSIST_T_DEC):
        pos = torch.full((CONSIST_B,), CONSIST_T_PRE + i, device=dev)
        logits, caches = decode_step(
            params, cfg, toks[:, CONSIST_T_PRE + i: CONSIST_T_PRE + i + 1],
            pos, caches)
        diff = (logits[:, 0] - ref[:, i]).abs()
        worst = max(worst, float(diff.max()))
        if bool((diff > CONSIST_TOL + CONSIST_TOL * ref[:, i].abs()).any()):
            raise AssertionError(f"consistency: decode step {i} diverged "
                                 f"from forward (max abs diff "
                                 f"{float(diff.max())})")
    torch.cuda.synchronize()
    print(f"consistency ({ARCH} full width, depth cut to {CONSIST_STACKS}, "
          f"f32, TF32 off for matmul and cuDNN): B={CONSIST_B} prefill "
          f"{CONSIST_T_PRE} (window {cfg.window}) + {CONSIST_T_DEC} decode "
          f"steps == forward within rtol=atol={CONSIST_TOL}; max abs diff "
          f"{worst:.3g}, max |logit| {float(ref.abs().max()):.3g} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return {"max_abs_diff": worst, "stacks": repr(CONSIST_STACKS)}


def device_breakdown(torch, fn) -> dict:
    """Run ``fn`` once under ``torch.profiler`` and sum the device time of
    its kernels by kind: the two LM kernels, matrix products (cuBLAS /
    CUTLASS), copies and the rest (elementwise, reductions, indexing).
    ``wall_ms`` is the host wall of the profiled call, synchronised;
    ``idle`` is the share of it in which no kernel ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kinds = {"flash_attention": 0.0, "rglru_scan": 0.0, "matmul": 0.0,
             "copy": 0.0, "other": 0.0}
    by_name: dict[str, float] = {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        name = ev.name
        us = ev.time_range.elapsed_us()
        if "flash_fwd" in name:
            kinds["flash_attention"] += us
        elif "rglru_scan" in name:          # either path's kernel
            kinds["rglru_scan"] += us
        elif any(k in name.lower() for k in ("gemm", "xmma", "cutlass",
                                             "nvjet")):
            kinds["matmul"] += us       # cuBLAS / cuBLASLt / CUTLASS
        elif "memcpy" in name.lower() or "memset" in name.lower():
            kinds["copy"] += us
        else:
            kinds["other"] += us
        by_name[name] = by_name.get(name, 0.0) + us
    out = {k: v / 1e3 for k, v in kinds.items()}
    busy = sum(out.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    self_ms = {ev.key: ev.self_device_time_total / 1e3
               for ev in prof.key_averages()}
    out.update(wall_ms=wall_ms, busy_ms=busy,
               idle=(1.0 - busy / wall_ms) if busy else None,
               top=[(n[:60], us / 1e3) for n, us in top],
               ops={label: sum(self_ms.get(op, 0.0) for op in ops)
                    for label, ops in MOE_OPS})
    return out


def print_breakdown(label: str, parts: dict) -> None:
    if not parts["busy_ms"]:
        print(f"{label}: the profiler saw no device time (not measured)")
        return
    print(f"{label} (torch.profiler, device ms): " + ", ".join(
        f"{k} {parts[k]:.2f}" for k in ("flash_attention", "rglru_scan",
                                        "matmul", "copy", "other"))
        + f"; busy {parts['busy_ms']:.2f} of {parts['wall_ms']:.2f} ms "
        f"wall, idle share {parts['idle']:.3f}", flush=True)
    for name, ms in parts["top"]:
        print(f"  {ms:9.2f} ms  {name}")


def lm_serving(torch, dev):
    """Phase 11: full width and depth in bf16: the prefill step, then the
    continuous batcher draining N_REQUESTS requests."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.rglru_scan import rglru_scan_cuda
    from repro_torch.models import decode_step, init_caches, init_params, \
        prefill
    from repro_torch.models.model import param_bytes, param_count
    from repro_torch.serve import ContinuousBatcher, Request, \
        make_prefill_step
    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    n_params, n_bytes = param_count(cfg), param_bytes(params)
    print(f"serving {ARCH}: {n_params} parameters, {n_bytes} bytes bf16 on "
          f"the card ({time.perf_counter() - t0:.1f} s to draw)", flush=True)

    flash_attention_cuda.launches = 0
    rglru_scan_cuda.launches = 0
    by_path = rglru_scan_cuda.launches_by_path
    by_path.update(dict.fromkeys(by_path, 0))
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    toks = torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_T), generator=g,
                         device=dev, dtype=torch.int32)
    step = make_prefill_step(cfg)
    walls = []
    for _ in range(3):                 # the first call warms the libraries
        caches = init_caches(cfg, PREFILL_B, PREFILL_T, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nxt, caches = step(params, toks, caches)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    if nxt.shape != (PREFILL_B,) or not bool(((nxt >= 0)
                                              & (nxt < cfg.vocab)).all()):
        raise AssertionError(f"prefill step gave tokens {nxt.tolist()}")
    logits, _ = prefill(params, cfg, toks, init_caches(
        cfg, PREFILL_B, PREFILL_T, device=dev), last_only=True)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("prefill logits are not all finite")
    del caches, logits
    prefill_s = float(np.median(walls[1:]))
    print(f"prefill step B={PREFILL_B} T={PREFILL_T}: {prefill_s:.3f} s "
          f"(median of {len(walls) - 1} after a warm-up of "
          f"{walls[0]:.3f} s), {PREFILL_B * PREFILL_T / prefill_s:.0f} "
          f"tokens/s", flush=True)
    prefill_parts = device_breakdown(torch, lambda: step(
        params, toks, init_caches(cfg, PREFILL_B, PREFILL_T, device=dev)))
    print_breakdown(f"prefill step B={PREFILL_B} T={PREFILL_T}",
                    prefill_parts)
    print(f"prefill: rglru_scan launches by path {by_path}", flush=True)
    if by_path["unaligned"] or not by_path["tma"]:
        raise AssertionError(f"the full-depth prefill's scans did not all "
                             f"take the tma path: {by_path}")

    rng = np.random.default_rng(SEED + 13)
    batcher = ContinuousBatcher(cfg, params, n_slots=N_SLOTS,
                                cache_len=CACHE_LEN, device=dev)
    reqs = [Request(i, rng.integers(0, cfg.vocab, int(n)).astype(np.int32),
                    max_new=MAX_NEW)
            for i, n in enumerate(rng.integers(*PROMPT_LENS, N_REQUESTS,
                                               endpoint=True))]
    for r in reqs:
        batcher.submit(r)
    decode_ticks, ticks = [], 0
    t_start = time.perf_counter()
    while batcher.queue or any(batcher.slot_req):
        admits = bool(batcher.queue) and None in batcher.slot_req
        t0 = time.perf_counter()
        batcher.tick()
        torch.cuda.synchronize()
        if not admits:
            decode_ticks.append(time.perf_counter() - t0)
        ticks += 1
        if ticks > 10_000:
            raise AssertionError("batcher did not drain")
    wall = time.perf_counter() - t_start
    n_tok = sum(len(r.out) for r in reqs)
    if sorted(r.rid for r in batcher.completed) != list(range(N_REQUESTS)):
        raise AssertionError("not every request completed")
    for r in reqs:
        if len(r.out) != MAX_NEW or not all(0 <= x < cfg.vocab
                                            for x in r.out):
            raise AssertionError(f"request {r.rid}: {len(r.out)} tokens "
                                 f"{r.out}")
    # one more decode step over the drained slots' caches, at the positions
    # the last four requests reached: its logits must be finite
    last = reqs[-N_SLOTS:]
    tokens = torch.tensor([[r.out[-1]] for r in last], dtype=torch.int32,
                          device=dev)
    pos = torch.tensor([len(r.prompt) + MAX_NEW - 1 for r in last],
                       device=dev)
    logits, _ = decode_step(params, cfg, tokens, pos, batcher.caches)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("decode logits are not all finite")
    decode_parts = device_breakdown(torch, lambda: decode_step(
        params, cfg, tokens, pos, batcher.caches))
    print_breakdown(f"decode step B={N_SLOTS}", decode_parts)
    launches = {"flash_attention": flash_attention_cuda.launches,
                "rglru_scan": rglru_scan_cuda.launches,
                "rglru_scan_by_path": dict(by_path)}
    print(f"batcher: {N_REQUESTS} requests (prompts "
          f"{sorted(len(r.prompt) for r in reqs)}), {N_SLOTS} slots, cache "
          f"{CACHE_LEN}: drained in {ticks} ticks, {n_tok} tokens, "
          f"{wall:.2f} s; median decode tick {np.median(decode_ticks) * 1e3:.1f} "
          f"ms ({len(decode_ticks)} ticks without admission); launches "
          f"{launches}", flush=True)
    if min(launches["flash_attention"], launches["rglru_scan"]) <= 0:
        raise AssertionError(f"serving did not launch every LM kernel: "
                             f"{launches}")
    if by_path["unaligned"]:
        raise AssertionError(f"a serving scan took the unaligned path: "
                             f"{by_path}")
    del params, batcher
    return launches, {"prefill_breakdown": prefill_parts,
                      "decode_breakdown": decode_parts,
                      "prefill_s": prefill_s,
                      "prefill_tokens_per_s": PREFILL_B * PREFILL_T
                      / prefill_s, "ticks": ticks, "tokens": n_tok,
                      "drain_s": wall,
                      "decode_tick_ms": float(np.median(decode_ticks)) * 1e3}


def _arch_cfg(arch, repeats=None, **moe):
    """``arch``'s config, each stack's repeats set to ``repeats`` (None:
    kept), the MoE config's fields replaced by ``moe``."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if repeats is not None:
        cut = lambda stacks: tuple((u, repeats) for u, _ in stacks)
        cfg = dataclasses.replace(cfg, stacks=cut(cfg.stacks),
                                  encoder_stacks=cut(cfg.encoder_stacks))
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe))
    return cfg


def _memory_stub(torch, dev, cfg, batch, seed, dtype):
    """The vlm / audio frontends' stub: N(0, 0.02) embeddings of
    ``memory_len`` patches or frames, as the reference's tests draw them."""
    if not cfg.memory_len:
        return None
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn((batch, cfg.memory_len, cfg.d_model), generator=g,
                        device=dev) * 0.02).to(dtype)


def arch_consistency(torch, dev):
    """Phase 10b: each attention family at full width, one repeat of each
    unit, f32 with TF32 off: prefill + 16 teacher-forced decode steps ==
    a cache-free forward within CONSIST_TOL.  MoE runs at capacity factor
    n_experts / top_k, so that no token is dropped at either token count
    (capacity depends on it, so forward and decode would otherwise drop
    different tokens, as in the reference)."""
    import gc
    from repro_torch.models import decode_step, forward, init_caches, \
        init_params, prefill
    from repro_torch.models.model import param_count, unembed
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for i, (arch, t_pre) in enumerate(ARCH_CONSIST):
        base = _arch_cfg(arch)
        moe = {} if base.moe is None else {
            "capacity_factor": base.moe.n_experts / base.moe.top_k}
        cfg = _arch_cfg(arch, 1, **moe)
        t0 = time.perf_counter()
        params = init_params(cfg, seed=SEED + i, dtype=torch.float32,
                             device=dev)
        n = t_pre + CONSIST_T_DEC
        g = torch.Generator(device=dev).manual_seed(SEED + 7 + i)
        toks = torch.randint(0, cfg.vocab, (CONSIST_B, n), generator=g,
                             device=dev, dtype=torch.int32)
        mem = _memory_stub(torch, dev, cfg, CONSIST_B, SEED + 9 + i,
                           torch.float32)
        hidden, _ = forward(params, cfg, toks, memory=mem,
                            return_hidden=True)
        ref = unembed(params, cfg, hidden[:, t_pre:])
        del hidden
        caches = init_caches(cfg, CONSIST_B, n, dtype=torch.float32,
                             device=dev)
        _, caches = prefill(params, cfg, toks[:, :t_pre], caches,
                            memory=mem, last_only=True)
        worst = 0.0
        for j in range(CONSIST_T_DEC):
            pos = torch.full((CONSIST_B,), t_pre + j, device=dev)
            logits, caches = decode_step(params, cfg,
                                         toks[:, t_pre + j: t_pre + j + 1],
                                         pos, caches)
            diff = (logits[:, 0] - ref[:, j]).abs()
            worst = max(worst, float(diff.max()))
            if bool((diff > CONSIST_TOL + CONSIST_TOL
                     * ref[:, j].abs()).any()) or \
                    not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"consistency {arch}: decode step {j} "
                                     f"diverged from forward (max abs diff "
                                     f"{float(diff.max())})")
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        out[arch] = {"stacks": repr(cfg.stacks),
                     "encoder_stacks": repr(cfg.encoder_stacks),
                     "params": param_count(cfg), "t_pre": t_pre,
                     "max_abs_diff": worst,
                     "max_abs_logit": float(ref.abs().max()),
                     "s": time.perf_counter() - t0}
        extra = "".join(
            (f" + encoder {cfg.encoder_stacks}" if cfg.encoder_stacks else "",
             f", {out[arch]['params']} parameters, f32, TF32 off",
             f", capacity factor {cfg.moe.capacity_factor}" if cfg.moe else "",
             f", memory {cfg.memory_len}" if cfg.memory_len else ""))
        print(f"consistency {arch} (full width, one repeat of each unit: "
              f"{cfg.stacks}{extra}"
              f"): B={CONSIST_B} prefill {t_pre} + {CONSIST_T_DEC} decode "
              f"steps == forward within rtol=atol={CONSIST_TOL}; max abs "
              f"diff {worst:.3g}, max |logit| "
              f"{out[arch]['max_abs_logit']:.3g}; peak {peak:.1f} GiB "
              f"({out[arch]['s']:.1f} s)", flush=True)
        del params, caches, ref, logits, mem
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return out


def serve_arch(torch, dev, arch, depth, card) -> dict:
    """Phase 11b for one architecture, bf16: the prefill step at B 4, T
    4,096 (whisper: its 448-token decoder context) with the memory stub
    where the family has one, then the batcher draining N_REQUESTS
    requests (decoder-only) or 16 greedy tokens through make_decode_step
    over the prefill's caches (vlm, audio: the batcher takes no memory).
    Flash's launch count is set to 0 before and must be > 0 after; then
    each flash instantiation the warm-up prefill made is held against the
    twin on its own inputs."""
    import gc
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     kernel_path)
    from repro_torch.models import decode_step, init_caches, init_params, \
        prefill
    from repro_torch.models.model import (active_param_count, param_bytes,
                                          param_count)
    from repro_torch.serve import ContinuousBatcher, Request, \
        make_decode_step, make_prefill_step
    cfg = _arch_cfg(arch, depth)
    full = _arch_cfg(arch)
    bf16 = torch.bfloat16
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, dtype=bf16, device=dev)
    torch.cuda.synchronize()
    res = {"params": param_count(cfg), "bytes": param_bytes(params),
           "active_params": active_param_count(cfg),
           "full_params": param_count(full), "layers": cfg.n_layers,
           "full_layers": full.n_layers,
           "weights_allocated_gib": torch.cuda.memory_allocated() / 2 ** 30}
    cut = "" if depth is None else \
        f", depth cut to {cfg.n_layers} of {full.n_layers} layers " \
        f"(full model {res['full_params']} parameters)"
    print(f"serving {arch}: {res['params']} parameters "
          f"({res['active_params']} active a token), {res['bytes']} bytes "
          f"bf16 on the card{cut}; memory_allocated "
          f"{res['weights_allocated_gib']:.2f} GiB "
          f"({time.perf_counter() - t0:.1f} s to draw)", flush=True)
    torch.cuda.reset_peak_memory_stats()
    flash_attention_cuda.launches = 0
    b, t = PREFILL_B, ARCH_PREFILL_T.get(arch, PREFILL_T)
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    toks = torch.randint(0, cfg.vocab, (b, t), generator=g, device=dev,
                         dtype=torch.int32)
    mem = _memory_stub(torch, dev, cfg, b, SEED + 12, bf16)
    step = make_prefill_step(cfg)
    walls, caches, seen = [], None, {}
    for i in range(3):    # the first call warms the libraries and records
        caches = None     # each flash instantiation the prefill makes
        fresh = init_caches(cfg, b, t + MAX_NEW, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with recording_flash(seen) if i == 0 else contextlib.nullcontext():
            nxt, caches = step(params, toks, fresh, memory=mem)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
        del fresh
    if nxt.shape != (b,) or not bool(((nxt >= 0) & (nxt < cfg.vocab)).all()):
        raise AssertionError(f"{arch}: prefill step gave tokens "
                             f"{nxt.tolist()}")
    res["prefill_s"] = float(np.median(walls[1:]))
    res["prefill_tokens_per_s"] = b * t / res["prefill_s"]
    print(f"{arch} prefill step B={b} T={t}"
          f"{' memory ' + str(cfg.memory_len) if mem is not None else ''}: "
          f"{res['prefill_s']:.3f} s (median of {len(walls) - 1} after a "
          f"warm-up of {walls[0]:.3f} s), "
          f"{res['prefill_tokens_per_s']:.0f} tokens/s [{card}]", flush=True)
    keep = caches if mem is not None else None
    caches = None
    got = {}

    def profiled_prefill():
        got["logits"], _ = prefill(params, cfg, toks, init_caches(
            cfg, b, t + MAX_NEW, device=dev), memory=mem, last_only=True)

    res["prefill_breakdown"] = device_breakdown(torch, profiled_prefill)
    if not bool(torch.isfinite(got.pop("logits")).all()):
        raise AssertionError(f"{arch}: prefill logits are not all finite")
    print_breakdown(f"{arch} prefill B={b} T={t}", res["prefill_breakdown"])
    if cfg.moe is not None:
        ops = res["prefill_breakdown"]["ops"]
        disp = sum(ms for label, ms in ops.items()
                   if label != "expert products")
        print(f"{arch} MoE ops in that prefill ({cfg.n_layers} layers, "
              f"torch.profiler self device ms): expert products "
              f"{ops['expert products']:.2f}; router top-k, dispatch and "
              f"combine {disp:.2f} (" + ", ".join(
                  f"{k} {v:.2f}" for k, v in ops.items()
                  if k != "expert products")
              + f"; scatter includes the caches' ring writes) [{card}]",
              flush=True)

    if mem is None:
        cache_dtype = bf16 if cfg.moe is not None else torch.float32
        rng = np.random.default_rng(SEED + 13)
        batcher = ContinuousBatcher(cfg, params, n_slots=N_SLOTS,
                                    cache_len=ARCH_CACHE_LEN,
                                    dtype=cache_dtype, device=dev)
        reqs = [Request(i, rng.integers(0, cfg.vocab, int(n)).astype(
            np.int32), max_new=MAX_NEW) for i, n in enumerate(
                rng.integers(*ARCH_PROMPTS, N_REQUESTS, endpoint=True))]
        for r in reqs:
            batcher.submit(r)
        ticks, n_ticks = [], 0
        t1 = time.perf_counter()
        while batcher.queue or any(batcher.slot_req):
            admits = bool(batcher.queue) and None in batcher.slot_req
            t2 = time.perf_counter()
            batcher.tick()
            torch.cuda.synchronize()
            if not admits:
                ticks.append(time.perf_counter() - t2)
            n_ticks += 1
            if n_ticks > 10_000:
                raise AssertionError(f"{arch}: batcher did not drain")
        wall = time.perf_counter() - t1
        if sorted(r.rid for r in batcher.completed) != \
                list(range(N_REQUESTS)) or any(
                    len(r.out) != MAX_NEW or not all(
                        0 <= x < cfg.vocab for x in r.out) for r in reqs):
            raise AssertionError(f"{arch}: a request did not complete with "
                                 f"{MAX_NEW} tokens in the vocabulary")
        last = reqs[-N_SLOTS:]
        tokens = torch.tensor([[r.out[-1]] for r in last], dtype=torch.int32,
                              device=dev)
        pos = torch.tensor([len(r.prompt) + MAX_NEW - 1 for r in last],
                           device=dev)
        dec_caches = batcher.caches
        n_tok = sum(len(r.out) for r in reqs)
        what = (f"batcher: {N_REQUESTS} requests (prompts "
                f"{sorted(len(r.prompt) for r in reqs)}), {N_SLOTS} slots, "
                f"cache {ARCH_CACHE_LEN} {str(cache_dtype)[6:]}: drained in "
                f"{n_ticks} ticks, {n_tok} tokens")
        res.update(ticks=n_ticks, cache_dtype=str(cache_dtype)[6:])
    else:
        batcher = None
        dec = make_decode_step(cfg)
        tok, dec_caches, ticks = nxt, keep, []
        out = [tok]
        t1 = time.perf_counter()
        for i in range(MAX_NEW):
            pos = torch.full((b,), t + i, device=dev)
            t2 = time.perf_counter()
            tok, dec_caches = dec(params, tok[:, None], pos, dec_caches)
            torch.cuda.synchronize()
            ticks.append(time.perf_counter() - t2)
            out.append(tok)
        wall = time.perf_counter() - t1
        gen = torch.stack(out, 1)
        if not bool(((gen >= 0) & (gen < cfg.vocab)).all()):
            raise AssertionError(f"{arch}: decode gave tokens {gen.tolist()}")
        tokens, pos = tok[:, None], torch.full((b,), t + MAX_NEW, device=dev)
        n_tok = b * MAX_NEW
        what = (f"greedy decode through make_decode_step: {MAX_NEW} steps "
                f"at B={b} over the prefill's caches (bf16), {n_tok} tokens")
    logits, _ = decode_step(params, cfg, tokens, pos, dec_caches)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{arch}: decode logits are not all finite")
    res["decode_breakdown"] = device_breakdown(torch, lambda: decode_step(
        params, cfg, tokens, pos, dec_caches))
    print_breakdown(f"{arch} decode step B={tokens.shape[0]}",
                    res["decode_breakdown"])
    res.update(decode_tick_ms=float(np.median(ticks)) * 1e3, drain_s=wall,
               tokens=n_tok, decode_tokens_per_s=n_tok / wall,
               flash_launches=flash_attention_cuda.launches,
               peak_allocated_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    print(f"{arch} {what}, {wall:.2f} s, {res['decode_tokens_per_s']:.1f} "
          f"tokens/s; median decode tick {res['decode_tick_ms']:.1f} ms; "
          f"flash launches {res['flash_launches']}; peak memory_allocated "
          f"{res['peak_allocated_gib']:.2f} GiB [{card}]", flush=True)
    attention = any(bt not in ("rglru", "mlstm", "slstm")
                    for unit, _ in cfg.stacks for bt in unit)
    if attention and res["flash_launches"] <= 0:
        raise AssertionError(f"{arch}: serving never launched "
                             f"flash_attention")
    del params, batcher, dec_caches, keep, logits, mem
    gc.collect()
    torch.cuda.empty_cache()
    # each flash instantiation of the prefill, at batch 1, on the card
    # inputs the model gave it, against the twin (after the launch count
    # was read, so these launches are not counted)
    res["flash_checks"] = []
    for key, (q, k, v, kw) in seen.items():
        dt, hd, h, hkv, tq, s, causal, window, softcap = key
        what = (f"{arch} {dt} hd={hd} H={h} Hkv={hkv} Tq={tq} S={s} "
                f"causal={causal} window={window} softcap={softcap}")
        err, tol, rel, rel_tol = flash_check(torch, what, q, k, v, kw)
        res["flash_checks"].append({
            "dtype": dt, "hd": hd, "h": h, "hkv": hkv, "tq": tq, "s": s,
            "causal": causal, "window": window, "softcap": softcap,
            "path": kernel_path(q.dtype, hd), "max_abs_err": err,
            "block_rel_err": rel})
        print(f"flash in {what} ({kernel_path(q.dtype, hd)}, B=1, as the "
              f"prefill gave it): within {tol} (max abs err {err:.3g}) and "
              f"block relative error {rel:.3g} <= {rel_tol}", flush=True)
    del seen
    torch.cuda.empty_cache()
    return res


def arch_serving(torch, dev, card) -> dict:
    """Phase 11b: every attention family in turn, each freed before the
    next."""
    out = {}
    for arch, depth in ARCH_SERVE:
        t0 = time.perf_counter()
        out[arch] = serve_arch(torch, dev, arch, depth, card)
        out[arch]["s"] = time.perf_counter() - t0
    return out


# Phase 13: the trainer at full width and depth (internlm2-1.8b, f32).
TRAIN_ARGV = ["--arch", "internlm2-1.8b", "--steps", "6", "--batch", "8",
              "--seq", "256", "--log-every", "1"]
TRAIN_PROFILE_STEP = 3       # the step run under the profiler (idle share)
# Phase 14: recurrentgemma-9b at full width, cut to one unit, f32.
RGLRU_TRAIN_STACKS = ((("rglru", "rglru", "local"), 1),)
RGLRU_TRAIN_B, RGLRU_TRAIN_T, RGLRU_TRAIN_STEPS = 2, 2048, 3
# The backward kernel's timed shapes: the forward's headline, and the
# training shape above (B 2, T 2,048, W 4,096).
RGLRU_BWD_SHAPES = (("headline", 4, 4096, 4096),
                    ("training", RGLRU_TRAIN_B, RGLRU_TRAIN_T, 4096))
RGLRU_BWD_DESIGN = ("one reverse-time pass: one producer warp TMA-loads g "
                    "at t0, a at t0 + 1 and h at t0 - 1 (rows outside [0, T) "
                    "zero-fill) as (64 x 32) tiles into a 3-stage ring, the "
                    "block walks the time tiles last to first, one consumer "
                    "warp steps its 32 channels downward with gacc in a "
                    "register, du and da tiles TMA-stored from two "
                    "alternating pairs; unaligned path: one thread a "
                    "channel, 16 steps' loads ahead")
# Phase 15: the xLSTM family through the trainer.
XLSTM_ARGV = ["--arch", "xlstm-350m", "--steps", "3", "--batch", "8",
              "--seq", "256", "--log-every", "1"]
# Phase 16b: reduced qwen3-moe through the trainer on the one-rank mesh.
MOE_ARGV = ["--arch", "qwen3-moe-235b-a22b", "--smoke", "--steps", "3",
            "--batch", "4", "--seq", "64", "--log-every", "1"]
# PR 19 call 13's training numbers (H100 80GB HBM3 at 700 W; the trainer on
# one card without a mesh), copied from PERF.md §5 and printed beside this
# run's on the text lines, never in the kernels line.
C13 = {"train_main": {"losses": [11.7918, 15.1184, 12.6806, 11.4881,
                                 12.348, 11.0938],
                      "s_per_step": 0.747, "peak_gib": 30.50},
       "train_rglru": {"losses": [25.457, 25.0316, 24.7373],
                       "s_per_step": 1.263, "peak_gib": 37.78},
       "train_xlstm": {"s_per_step": 3.451, "peak_gib": 7.54}}
# Phase 16: fault tolerance, the reference's die / resume contract.
RESUME_CMD = ["-m", "repro_torch.launch.train", "--smoke", "--steps", "20",
              "--batch", "2", "--seq", "64", "--ckpt-every", "10",
              "--log-every", "1"]
RESUME_TOL = 1e-5            # tests/test_substrate.py's post-resume bound


@contextlib.contextmanager
def timed_train_steps(torch, record: dict, profile_at: int | None = None):
    """While open, every train step ``launch.train`` builds is timed on the
    host clock between two synchronisations (``record["walls"]``, seconds),
    and step ``profile_at`` runs once under the profiler
    (``record["breakdown"]``, ``device_breakdown``'s dict)."""
    import repro_torch.launch.train as lt
    inner = lt.make_train_step
    record.setdefault("walls", [])

    def make(*args, **kw):
        step = inner(*args, **kw)

        def timed(params, opt, batch):
            record.setdefault("mesh", mesh_facts(params))
            out = {}

            def run():
                out["r"] = step(params, opt, batch)

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if len(record["walls"]) == profile_at:
                record["breakdown"] = device_breakdown(torch, run)
            else:
                run()
            torch.cuda.synchronize()
            record["walls"].append(time.perf_counter() - t0)
            return out["r"]
        return timed

    lt.make_train_step = make
    try:
        yield record
    finally:
        lt.make_train_step = inner


def mesh_facts(params) -> dict:
    """How a train step holds its parameters: the process group's backend,
    how many of the leaves are DTensors, on which devices, over which
    mesh."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.tree import tree_leaves
    leaves = tree_leaves(params)
    dts = [t for t in leaves if isinstance(t, DTensor)]
    mesh = dts[0].device_mesh if dts else None
    return {"backend": dist.get_backend(), "dtensors": len(dts),
            "leaves": len(leaves),
            "devices": sorted({str(t.to_local().device) for t in dts}),
            "mesh": None if mesh is None else
            dict(zip(mesh.mesh_dim_names, mesh.shape))}


def check_mesh(facts: dict, what: str) -> str:
    """The trainer's mesh path on the card: every parameter a DTensor on
    cuda:0 over the one-rank NCCL (data 1, model 1) mesh.  Returns the
    line's text."""
    ok = (facts["backend"] == "nccl" and facts["leaves"] > 0
          and facts["dtensors"] == facts["leaves"]
          and facts["devices"] == ["cuda:0"]
          and facts["mesh"] == {"data": 1, "model": 1})
    if not ok:
        raise AssertionError(f"{what}: not the one-rank NCCL mesh path: "
                             f"{facts}")
    return (f"{facts['backend']} group of 1 rank, mesh {facts['mesh']}, "
            f"{facts['dtensors']} of {facts['leaves']} parameters DTensors "
            f"on {facts['devices'][0]}")


def beside_c13(what: str, losses, step_s: float, peak: float) -> str:
    """This run's training numbers beside PR 19 call 13's (copied)."""
    c = C13[what]
    was = f"losses {c['losses']}, " if "losses" in c else ""
    return (f"PR 19 c13 (one card, no mesh; copied from PERF.md): {was}"
            f"{c['s_per_step']} s/step, peak {c['peak_gib']} GiB; this run "
            f"{[round(x, 4) for x in losses]}, {step_s:.3f} s/step, peak "
            f"{peak:.2f} GiB")


def train_cli(torch, argv, card, what, profile_at=None) -> dict:
    """Run ``launch.train.main(argv)`` on the card with its steps timed:
    every loss finite and the last below the first; s/step and tokens/s
    (the median step after the first, the profiled one left out), peak
    memory_allocated, and the profiled step's breakdown."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.launch.train import main as train_main
    from repro_torch.models.model import param_count
    arch = argv[argv.index("--arch") + 1]
    batch = int(argv[argv.index("--batch") + 1])
    seq = int(argv[argv.index("--seq") + 1])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with timed_train_steps(torch, {}, profile_at) as rec:
        losses = train_main(list(argv))
    total = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{what}: losses {losses} are not finite and "
                             f"falling")
    steady = [w for i, w in enumerate(rec["walls"])
              if i > 0 and i != profile_at]
    step_s = float(np.median(steady))
    tokens = batch * (seq + 1)               # the step reads T+1 tokens
    res = {"arch": arch, "argv": argv, "params": param_count(
        get_config(arch)), "losses": losses, "step_walls_s": rec["walls"],
        "s_per_step": step_s, "tokens_per_s": tokens / step_s,
        "first_step_s": rec["walls"][0], "total_s": total,
        "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    print(f"{what}: {arch} at full width and depth ({res['params']} "
          f"parameters, f32), B={batch} T={seq}+1, {len(losses)} steps: "
          f"losses {[round(x, 4) for x in losses]} (finite, falling); "
          f"{step_s:.3f} s/step (median after the first, which took "
          f"{res['first_step_s']:.3f} s), {res['tokens_per_s']:.0f} "
          f"tokens/s; peak memory_allocated "
          f"{res['peak_allocated_gib']:.2f} GiB ({total:.1f} s in all) "
          f"[{card}]", flush=True)
    res["mesh"] = rec["mesh"]
    print(f"{what}: {check_mesh(rec['mesh'], what)}; "
          f"{beside_c13(what, losses, step_s, res['peak_allocated_gib'])} "
          f"[{card}]", flush=True)
    if what == "train_main" and \
            [round(x, 4) for x in losses] != C13[what]["losses"]:
        raise AssertionError(f"{what}: losses {losses} differ from PR 19 "
                             f"c13's {C13[what]['losses']}")
    if "breakdown" in rec:
        res["breakdown"] = rec["breakdown"]
        print_breakdown(f"{what}: train step {profile_at}", rec["breakdown"])
    return res


def rglru_backward_check(torch, dev, card) -> dict:
    """Phase 14's second half: the backward kernel at RGLRU_BWD_SHAPES, f32,
    on g, a and h = the forward kernel's states, held torch.equal to its
    twin on the card and to the port's backward before the kernel (the
    forward kernel on time-flipped inputs, ``flip_backward``), and one
    autograd backward through RGLRUScan to the kernel's du and da.  Timed
    by CUDA events in turns kernel, old, old, kernel, the kernel in bursts
    of 20 and one call under the profiler (its own time, the wrapper's host
    span), the autograd backward, the twin, beside the bound: read g, a,
    h; write du, da."""
    from repro_torch.kernels.rglru_scan import (RGLRUScan, rglru_scan_cuda,
                                                rglru_scan_backward_cuda,
                                                rglru_scan_backward_torch,
                                                scan_path)
    shapes = []
    for i, (name, b, t, w) in enumerate(RGLRU_BWD_SHAPES):
        gen = torch.Generator(device=dev).manual_seed(SEED + 21 + i)
        u = torch.randn((b, t, w), generator=gen, device=dev)
        a = torch.rand((b, t, w), generator=gen, device=dev)
        g = torch.randn((b, t, w), generator=gen, device=dev)
        h, _ = rglru_scan_cuda(u, a)
        tu, ta = u.clone().requires_grad_(True), a.clone().requires_grad_(True)
        th = RGLRUScan.apply(tu, ta)

        def kernel(g=g, a=a, h=h):
            return rglru_scan_backward_cuda(g, a, h)

        def old(g=g, a=a, h=h):
            return flip_backward(torch, rglru_scan_cuda, g, a, h)

        def autograd(th=th, tu=tu, ta=ta, g=g):
            return torch.autograd.grad(th, (tu, ta), g, retain_graph=True)

        def twin(g=g, a=a, h=h):
            return rglru_scan_backward_torch(g, a, h)

        path = scan_path(g, a, h)
        got, want, was, via = kernel(), twin(), old(), autograd()
        torch.cuda.synchronize()
        err = max(float((x - y).abs().max()) for x, y in zip(got, want))
        equal = {"twin": all(map(torch.equal, got, want)),
                 "old": all(map(torch.equal, got, was)),
                 "autograd": all(map(torch.equal, got, via))}
        if not all(equal.values()):
            raise AssertionError(f"rglru backward {name}: kernel ({path}) "
                                 f"torch.equal {equal} (max abs err to the "
                                 f"twin {err})")
        del got, want, was, via
        turns = [median_ms(torch, fn) for fn in (kernel, old, old, kernel)]
        ms, old_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        b_ms = burst_ms(torch, kernel)
        auto_ms = median_ms(torch, autograd)
        prof = one_call_profile(torch, kernel, "rglru_scan_bwd")
        plain_ms = median_ms(torch, twin, reps=3, warmup=1)
        n = b * t * w
        nbytes = 5 * n * 4                   # read g, a, h; write du, da
        ops = 3 * n              # the chain's product and sum, da's product
        byte_ms, op_ms = nbytes / HBM_BPS * 1e3, ops / F32_OPS * 1e3
        bound = max(byte_ms, op_ms)
        res = {"case": name, "b": b, "t": t, "w": w, "path": path,
               "max_abs_err": err, "equal": equal, "ms": ms,
               "turns_ms": turns, "burst_ms": b_ms, "old_ms": old_ms,
               "autograd_ms": auto_ms, "plain_ms": plain_ms,
               "library_ms": None, "bound_ms": bound,
               "bound_by": "bytes" if byte_ms >= op_ms else "operations",
               "bytes": nbytes, "share": bound / ms,
               "burst_share": bound / b_ms, "old_share": bound / old_ms,
               "one_call_profile": prof}
        shapes.append(res)
        print(f"rglru backward {name} B={b} T={t} W={w} f32: path {path}, "
              f"du and da torch.equal to the twin, to the old flip-based "
              f"backward and to one autograd backward (max abs err 0); "
              f"kernel {ms:.4f} ms one call (turns kernel, old, old, kernel: "
              f"{', '.join(f'{x:.4f}' for x in turns)}), {b_ms:.4f} ms in "
              f"bursts of 20; the old flip-based backward {old_ms:.4f} ms; "
              f"one autograd backward {auto_ms:.4f} ms; plain (the twin's "
              f"loop) {plain_ms:.2f} ms; library none (no single PyTorch "
              f"call computes the recurrence); bound {bound:.4f} ms "
              f"({res['bound_by']}: {nbytes} bytes), {res['share']:.1%} of "
              f"bound ({res['burst_share']:.1%} in bursts; the old "
              f"{res['old_share']:.1%}) [{card}]", flush=True)
        if prof["recorded"]:
            print(f"rglru backward {name} one call under the profiler "
                  f"({prof['recorded']} of {prof['reps']} recorded): events "
                  f"{prof['event_ms']:.4f} ms = kernel "
                  f"{prof['kernel_ms']:.4f} ms + "
                  f"{prof['outside_kernel_ms'] * 1e3:.1f} us outside it; "
                  f"the wrapper's host span {prof['host_span_us']:.1f} us",
                  flush=True)
        else:
            print(f"rglru backward {name} one call under the profiler: no "
                  f"call's kernel recorded, not measured", flush=True)
        del u, a, g, h, tu, ta, th
        torch.cuda.empty_cache()
    return {"shapes": shapes}


@contextlib.contextmanager
def recording_scan(seen: dict):
    """While open, every scan the model makes (through
    ``blocks.RGLRUScan``) goes on as before, and the first forward and the
    first backward each keep copies of their inputs and of what the kernel
    gave back: ``seen["forward"] = (u, a, h)``, ``seen["backward"] = (g, a,
    h, du, da)``."""
    from repro_torch.models import blocks
    inner = blocks.RGLRUScan

    class Recording(inner):
        @staticmethod
        def forward(ctx, u, a):
            h = inner.forward(ctx, u, a)
            if "forward" not in seen:
                seen["forward"] = (u.detach().clone(), a.detach().clone(),
                                   h.clone())
            return h

        @staticmethod
        def backward(ctx, g):
            a, h = ctx.saved_tensors     # unpacked once under checkpoint
            du, da = inner.backward(
                types.SimpleNamespace(saved_tensors=(a, h)), g)
            if "backward" not in seen:
                seen["backward"] = (g.clone(), a.clone(), h.clone(),
                                    du.clone(), da.clone())
            return du, da

    blocks.RGLRUScan = Recording
    try:
        yield seen
    finally:
        blocks.RGLRUScan = inner


def flip_backward(torch, scan, g, a, h):
    """RGLRUScan's backward as the port ran it before its backward kernel
    (PRs 19 to 21): the forward scan ``scan`` (the kernel's wrapper or its
    twin) on time-flipped g and a_next, flipped back; da = gacc * h_prev.
    Returns (du, da)."""
    a_next = torch.cat([a[:, 1:], torch.ones_like(a[:, :1])], 1)
    rev, _ = scan(g.flip(1).contiguous(), a_next.flip(1).contiguous())
    gacc = rev.flip(1)
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], 1)
    return gacc, gacc * h_prev


def scan_twin_backward(torch, g, a, h):
    """RGLRUScan's backward computed with the forward scan's twin on
    flipped time: (du, da)."""
    from repro_torch.kernels.rglru_scan import rglru_scan_torch
    return flip_backward(torch, rglru_scan_torch, g, a, h)


def check_recorded_scans(torch, seen: dict, card) -> dict:
    """The scans recorded in a training step, held to the twin on the same
    inputs on the card with torch.equal: the forward's h from (u, a), the
    backward's du and da from (g, a, h)."""
    from repro_torch.kernels.rglru_scan import rglru_scan_torch
    if set(seen) != {"forward", "backward"}:
        raise AssertionError(f"train {ARCH}: recorded scans {sorted(seen)}, "
                             f"want a forward and a backward")
    u, a, h = seen["forward"]
    want_h, _ = rglru_scan_torch(u, a)
    g, ab, hb, du, da = seen["backward"]
    want_du, want_da = scan_twin_backward(torch, g, ab, hb)
    pairs = {"h": (h, want_h), "du": (du, want_du), "da": (da, want_da)}
    errs = {k: float((x - y).abs().max()) for k, (x, y) in pairs.items()}
    equal = {k: torch.equal(x, y) for k, (x, y) in pairs.items()}
    res = {"shape": list(u.shape), "max_abs_err": errs, "equal": equal}
    print(f"train {ARCH}: the first step's first scan forward and first "
          f"scan backward, shape {tuple(u.shape)}, against the twin on "
          f"the same inputs on the card: torch.equal {equal}, max abs err "
          f"{errs} [{card}]", flush=True)
    if not all(equal.values()):
        raise AssertionError(f"train {ARCH}: the training step's scans "
                             f"differ from the twin: {errs}")
    return res


def train_rglru(torch, dev, card) -> dict:
    """Phase 14: recurrentgemma-9b at full width cut to one (rglru, rglru,
    local) unit, f32: RGLRU_TRAIN_STEPS steps of make_train_step at B 2,
    T 2,048 with the scan's launch counts set to 0 before and read after
    (forward: once a layer in the forward and once in its recomputation
    under remat; backward: once a layer); then the backward's check."""
    import dataclasses
    import gc
    from repro_torch.configs import get_config
    from repro_torch.kernels.rglru_scan import (rglru_scan_backward_cuda,
                                                rglru_scan_cuda)
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import make_host_mesh, place
    from repro_torch.models import init_params
    from repro_torch.models.model import activation_sharding, param_count
    from repro_torch.train import AdamWConfig, init_opt_state, \
        make_train_step
    cfg = dataclasses.replace(get_config(ARCH), stacks=RGLRU_TRAIN_STACKS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mesh = make_host_mesh()
    params = init_params(cfg, seed=SEED, dtype=torch.float32, device=dev)
    opt = init_opt_state(params)
    params = place(params, sh.param_shardings(mesh, params), mesh)
    opt = place(opt, sh.opt_shardings(mesh, opt), mesh)
    facts = mesh_facts(params)
    step = make_train_step(cfg, AdamWConfig(lr=3e-4, warmup_steps=1,
                                            total_steps=RGLRU_TRAIN_STEPS))
    g = torch.Generator(device=dev).manual_seed(SEED + 17)
    n_rglru = sum(r * u.count("rglru") for u, r in cfg.stacks)
    by_path = rglru_scan_cuda.launches_by_path
    bwd_by_path = rglru_scan_backward_cuda.launches_by_path
    rglru_scan_cuda.launches = rglru_scan_backward_cuda.launches = 0
    by_path.update(dict.fromkeys(by_path, 0))
    bwd_by_path.update(dict.fromkeys(bwd_by_path, 0))
    losses, walls, seen = [], [], {}
    for i in range(RGLRU_TRAIN_STEPS):
        toks = torch.randint(0, cfg.vocab, (RGLRU_TRAIN_B, RGLRU_TRAIN_T),
                             generator=g, device=dev, dtype=torch.int32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with activation_sharding(mesh, batch=RGLRU_TRAIN_B), \
                recording_scan(seen) if i == 0 else contextlib.nullcontext():
            params, opt, m = step(params, opt, {"tokens": toks})
        losses.append(float(m["loss"]))
        walls.append(time.perf_counter() - t0)
    fwd, bwd = rglru_scan_cuda.launches, rglru_scan_backward_cuda.launches
    res = {"stacks": repr(cfg.stacks), "params": param_count(cfg),
           "losses": losses, "step_walls_s": walls,
           "forward_launches": fwd, "backward_launches": bwd,
           "launches_by_path": dict(by_path),
           "backward_launches_by_path": dict(bwd_by_path),
           "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    print(f"train {ARCH} (full width, depth cut to {cfg.stacks}, "
          f"{res['params']} parameters, f32): {RGLRU_TRAIN_STEPS} steps of "
          f"make_train_step at B={RGLRU_TRAIN_B} T={RGLRU_TRAIN_T}: losses "
          f"{[round(x, 4) for x in losses]}, step walls "
          f"{[round(x, 3) for x in walls]} s; launches: the forward scan "
          f"kernel {fwd} (forward + remat recompute, by path "
          f"{dict(by_path)}), the backward kernel {bwd} (by path "
          f"{dict(bwd_by_path)}); peak memory_allocated "
          f"{res['peak_allocated_gib']:.2f} GiB [{card}]", flush=True)
    res["mesh"] = facts
    c13 = beside_c13("train_rglru", losses, float(np.median(walls[1:])),
                     res["peak_allocated_gib"])
    print(f"train {ARCH}: {check_mesh(facts, 'train_rglru')}; {c13} "
          f"[{card}]", flush=True)
    want = (2 * n_rglru * RGLRU_TRAIN_STEPS, n_rglru * RGLRU_TRAIN_STEPS)
    if (fwd, bwd) != want or by_path["unaligned"] or \
            bwd_by_path["unaligned"] or not all(np.isfinite(losses)):
        raise AssertionError(f"train {ARCH}: scan launches forward {fwd}, "
                             f"backward {bwd} (want {want}, all tma: "
                             f"{dict(by_path)}, {dict(bwd_by_path)}); "
                             f"losses {losses}")
    del params, opt, m
    gc.collect()
    torch.cuda.empty_cache()
    res["recorded"] = check_recorded_scans(torch, seen, card)
    del seen
    res["backward"] = rglru_backward_check(torch, dev, card)
    return res


def train_resume(torch, card) -> dict:
    """Phase 16: the trainer in subprocesses on the card (reduced
    internlm2-1.8b): uninterrupted, killed at step 12 (exit 42) and
    resumed from the step-10 checkpoint; steps 10 to 19 equal within
    RESUME_TOL.  Then 12 compressed steps whose loss falls.  Checkpoints go
    to a temporary directory, removed after."""
    import os
    import tempfile
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

    def start(*extra):
        return subprocess.Popen([sys.executable, *RESUME_CMD, *extra],
                                cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    def finish(proc, what):
        try:
            out, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise AssertionError(f"train_resume: {what} did not finish")
        return proc.returncode, out, err

    def losses(d):
        rows = [json.loads(line) for line in
                (Path(d) / "metrics.jsonl").read_text().splitlines()]
        return {r["step"]: r["loss"] for r in rows}

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        full, fault, comp = (f"{tmp}/{n}" for n in ("full", "fault",
                                                     "compress"))
        procs = {"uninterrupted": start("--ckpt-dir", full),
                 "die at 12": start("--ckpt-dir", fault, "--die-at-step",
                                    "12"),
                 "compress": start("--ckpt-dir", comp, "--compress",
                                   "--steps", "12", "--ckpt-every", "6")}
        done = {k: finish(p, k) for k, p in procs.items()}
        meshes = {k: next((line for line in v[1].splitlines()
                           if line.startswith("mesh: ")), "")
                  for k, v in done.items()}
        for k, line in meshes.items():
            if "nccl" not in line or "cuda:0" not in line:
                raise AssertionError(f"train_resume: {k} did not train on "
                                     f"the one-rank NCCL mesh: {line!r}")
        rc, out, err = done["die at 12"]
        if rc != 42 or "SIMULATED FAILURE at step 12" not in out:
            raise AssertionError(f"train_resume: --die-at-step 12 exited "
                                 f"{rc}: {err[-2000:]}")
        for k in ("uninterrupted", "compress"):
            if done[k][0] != 0:
                raise AssertionError(f"train_resume: {k} exited "
                                     f"{done[k][0]}: {done[k][2][-2000:]}")
        rc, out, err = finish(start("--ckpt-dir", fault, "--resume"),
                              "resume")
        if rc != 0 or "resumed from step 10" not in out:
            raise AssertionError(f"train_resume: --resume exited {rc}, "
                                 f"printed {out[-500:]!r}: {err[-2000:]}")
        a, b, c = losses(full), losses(fault), losses(comp)
    diff = max(abs(a[s] - b[s]) for s in range(10, 20))
    comp_losses = [c[s] for s in sorted(c)]
    res = {"mesh": meshes["uninterrupted"],
           "max_abs_diff_steps_10_19": diff,
           "uninterrupted": [a[s] for s in sorted(a)],
           "resumed": [b[s] for s in sorted(b)], "compress": comp_losses,
           "s": time.perf_counter() - t0}
    print(f"train_resume (reduced internlm2-1.8b on the card, subprocesses, "
          f"each {res['mesh']!r}): die at step 12 exited 42, --resume "
          f"printed 'resumed from step 10'; steps 10 to 19 max abs loss diff {diff:.3g} (bound "
          f"{RESUME_TOL}); --compress 12 steps: loss {comp_losses[0]:.4f} -> "
          f"{comp_losses[-1]:.4f} ({res['s']:.1f} s) [{card}]", flush=True)
    if diff >= RESUME_TOL:
        raise AssertionError(f"train_resume: resumed losses differ from the "
                             f"uninterrupted run's by {diff}")
    if len(comp_losses) != 12 or not comp_losses[-1] < comp_losses[0]:
        raise AssertionError(f"train_resume: compressed losses "
                             f"{comp_losses} do not fall")
    return res


def train_moe(torch, card) -> dict:
    """Phase 16b: reduced qwen3-moe through the trainer on the one-rank
    NCCL mesh, with each call of the two MoE paths counted.  At a model
    axis of 1 the reference takes its single-device dispatch, and so must
    the port; expert parallelism needs a model axis > 1, so several
    cards."""
    from repro_torch.launch.train import main as train_main
    from repro_torch.models import blocks
    names = ("_apply_moe_xla", "_apply_moe_shardmap")
    saved = {n: getattr(blocks, n) for n in names}
    calls = dict.fromkeys(names, 0)

    def counting(name, fn):
        def run(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return run

    rec = {}
    t0 = time.perf_counter()
    for n, fn in saved.items():
        setattr(blocks, n, counting(n, fn))
    try:
        with timed_train_steps(torch, rec):
            losses = train_main(list(MOE_ARGV))
    finally:
        for n, fn in saved.items():
            setattr(blocks, n, fn)
    res = {"argv": MOE_ARGV, "losses": losses, "calls": calls,
           "mesh": rec["mesh"], "s": time.perf_counter() - t0}
    print(f"train_moe: reduced qwen3-moe-235b-a22b through the trainer, "
          f"{check_mesh(rec['mesh'], 'train_moe')}: {len(losses)} steps, "
          f"losses {[round(x, 4) for x in losses]}; apply_moe took "
          f"_apply_moe_xla {calls['_apply_moe_xla']} times and "
          f"_apply_moe_shardmap {calls['_apply_moe_shardmap']} times (the "
          f"reference's branch at a model axis of 1); expert parallelism "
          f"needs a model axis > 1 and waits for a machine with several "
          f"cards ({res['s']:.1f} s) [{card}]", flush=True)
    if calls["_apply_moe_shardmap"] or not calls["_apply_moe_xla"] or \
            not all(np.isfinite(losses)):
        raise AssertionError(f"train_moe: MoE calls {calls}, losses "
                             f"{losses}")
    return res


# Phase 17: prefill and decode under the one-rank (data 1, model 1) mesh:
# (arch, repeats kept: None for full depth; qwen3-moe at phase 11b's 11 of
# 94 layers), each against the same steps without a mesh.  PERF.md §5's
# no-mesh numbers for the same models, copied (H100 80GB HBM3, 700 W):
# prefill tokens/s at B 4, T 4,096; the batcher's median decode tick.
SERVE_MESH = (("recurrentgemma-9b", None), ("internlm2-1.8b", None),
              ("qwen3-moe-235b-a22b", 11), ("xlstm-350m", 2))
SERVE_MESH_TICKS = 8
# phase 17 also serves this model bound under the zero3 policy
ZERO3_ARCH = "recurrentgemma-9b"
PERF_NO_MESH = {"recurrentgemma-9b": "25,792 tokens/s, tick 70.2 ms",
                "internlm2-1.8b": "101,692 tokens/s, tick 48.9 ms, peak "
                                  "7.7 GiB",
                "qwen3-moe-235b-a22b": "41,645 tokens/s, tick 36.8 ms, "
                                       "peak 59.9 GiB",
                "xlstm-350m": "4,507 / 3,143 tokens/s (batcher tick 26.4 "
                              "/ 19.9 ms, peak 2.9 / 3.0 GiB)"}
# the block types that attend (flash at prefill)
ATTENTION_BLOCKS = {"attn", "local", "enc", "moe", "cross", "self+cross"}


def serve_steps(torch, dev, cfg, params, toks, mesh, specs):
    """Prefill then SERVE_MESH_TICKS greedy decode ticks; without a mesh
    the plain steps, on one the steps ``make_step_and_specs`` binds, over
    arguments placed by its placements.  Returns the tokens of each step
    (whole), the prefill's seconds, each tick's seconds and the peak GiB."""
    from repro_torch.launch.mesh import distribute_tree
    from repro_torch.models import init_caches
    from repro_torch.serve import make_decode_step, make_prefill_step
    b, t = toks.shape
    caches = init_caches(cfg, b, t + SERVE_MESH_TICKS, device=dev)
    if mesh is None:
        pre, dec = make_prefill_step(cfg), make_decode_step(cfg)
    else:
        (pre, pre_in), (dec, dec_in) = specs
        params = distribute_tree(params, pre_in[0], mesh)
        caches = distribute_tree(caches, pre_in[2], mesh)
        toks = distribute_tree(toks, pre_in[1], mesh)

    def whole(x):
        return x.full_tensor() if hasattr(x, "full_tensor") else x

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out, ticks = [], []
    with torch.no_grad():
        t0 = time.perf_counter()
        nxt, caches = pre(params, toks, caches)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        for i in range(SERVE_MESH_TICKS):
            cur = whole(nxt)
            out.append(cur)
            cur = cur[:, None]
            pos = torch.full((b,), t + i, dtype=torch.int32, device=dev)
            if mesh is not None:
                cur = distribute_tree(cur, dec_in[1], mesh)
                pos = distribute_tree(pos, dec_in[2], mesh)
            t0 = time.perf_counter()
            nxt, caches = dec(params, cur, pos, caches)
            torch.cuda.synchronize()
            ticks.append(time.perf_counter() - t0)
        out.append(whole(nxt))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del caches
    return out, prefill_s, ticks, peak


def serve_mesh(torch, dev, card) -> dict:
    """Phase 17: each of SERVE_MESH in bf16 at full width on the one-rank
    NCCL (data 1, model 1) mesh: parameters and caches placed by the rules
    (the caches' batch over the data axes), prefill at B 4, T 4,096 and
    SERVE_MESH_TICKS greedy decode ticks through the steps
    ``make_step_and_specs`` binds, against the same steps without a mesh on
    the same inputs (run before it, to warm the model up, and after it):
    every token ``torch.equal`` (at 1 x 1 the mesh moves nothing).  The MoE
    model runs both under deterministic algorithms (its combine's
    ``index_add_`` otherwise adds in a racing order).  Flash and the scan
    are counted from 0 just before each model's run on the mesh and read
    just after it, and again around the run after it without the mesh:
    on the mesh flash must launch exactly for the models that attend, the
    scan exactly for the RG-LRU one, and each as often as without the
    mesh.  ZERO3_ARCH runs on the mesh a second time, bound under the
    ``zero3`` policy, held to the same."""
    import gc
    import warnings
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import ShapeSpec
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.rglru_scan import rglru_scan_cuda
    from repro_torch.launch.specs import make_step_and_specs
    from repro_torch.models import init_params
    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    b, t = PREFILL_B, PREFILL_T

    def counted(*args):
        """serve_steps(*args) with flash and the scan counted from 0 just
        before it and read just after: (its result, the two counts)."""
        flash_attention_cuda.launches = 0
        rglru_scan_cuda.launches = 0
        out = serve_steps(*args)
        return out, {"flash": flash_attention_cuda.launches,
                     "scan": rglru_scan_cuda.launches}

    res = {}
    for arch, depth in SERVE_MESH:
        cfg = _arch_cfg(arch, depth)
        params = init_params(cfg, seed=SEED, dtype=torch.bfloat16,
                             device=dev)
        g = torch.Generator(device=dev).manual_seed(SEED + 17)
        toks = torch.randint(0, cfg.vocab, (b, t), generator=g, device=dev,
                             dtype=torch.int32)
        # the zero3 policy's run: ZERO3_ARCH only
        policies = ("2d", "zero3") if arch == ZERO3_ARCH else ("2d",)
        specs = {}
        for policy in policies:
            specs[policy] = []
            for kind in ("prefill", "decode"):
                step, _, in_pl, _, _ = make_step_and_specs(
                    cfg, ShapeSpec("serve", t + SERVE_MESH_TICKS, b, kind),
                    mesh, policy=policy)
                specs[policy].append((step, in_pl))
        meshes = [("mesh", mesh, specs["2d"])] + [
            (f"{policy} mesh", mesh, specs[policy])
            for policy in policies[1:]] + [("no mesh", None, None)]
        moe = cfg.moe is not None
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            torch.use_deterministic_algorithms(moe, warn_only=True)
            try:
                # without a mesh first (it warms the model's first calls up
                # and gives the tokens), then on the mesh, then without
                # again (the numbers printed beside the mesh's)
                warm = serve_steps(torch, dev, cfg, params, toks, None, None)
                runs, launches = {}, {}
                for name, m, sp in meshes:
                    runs[name], launches[name] = counted(
                        torch, dev, cfg, params, toks, m, sp)
            finally:
                torch.use_deterministic_algorithms(False)
        want = warm[0]
        for name, (got, *_) in runs.items():
            if not all(torch.equal(a, c) for a, c in zip(got, want)):
                raise AssertionError(
                    f"serve_mesh {arch}: tokens {name} "
                    f"{[x.tolist() for x in got]} != the first run's "
                    f"{[x.tolist() for x in want]}")
        row = {"layers": cfg.n_layers, "steps": len(got),
               "launches_serve_mesh": launches["mesh"],
               "launches_no_mesh": launches["no mesh"]}
        if "zero3 mesh" in launches:
            row["launches_zero3_mesh"] = launches["zero3 mesh"]
        for name, (_, pre_s, ticks, peak) in runs.items():
            row[name] = {"prefill_tokens_per_s": b * t / pre_s,
                         "decode_tick_ms": float(np.median(ticks)) * 1e3,
                         "peak_gib": peak}
        res[arch] = row
        print(f"serve_mesh {arch} ({cfg.n_layers} layers, bf16, mesh "
              f"{{data 1, model 1}} on nccl): prefill B={b} T={t} + "
              f"{SERVE_MESH_TICKS} decode ticks, tokens equal to the steps "
              f"without a mesh; mesh: "
              f"{row['mesh']['prefill_tokens_per_s']:.0f} tokens/s, tick "
              f"{row['mesh']['decode_tick_ms']:.1f} ms, peak "
              f"{row['mesh']['peak_gib']:.2f} GiB; no mesh in this run: "
              f"{row['no mesh']['prefill_tokens_per_s']:.0f} tokens/s, "
              f"tick {row['no mesh']['decode_tick_ms']:.1f} ms, peak "
              f"{row['no mesh']['peak_gib']:.2f} GiB (after a warm-up run "
              f"without it); PERF.md §5 without a mesh, copied: "
              f"{PERF_NO_MESH[arch]}; launches on the mesh: flash "
              f"{launches['mesh']['flash']}, scan {launches['mesh']['scan']}"
              f" (without it: flash {launches['no mesh']['flash']}, scan "
              f"{launches['no mesh']['scan']}) [{card}]", flush=True)
        if "zero3 mesh" in row:
            z, m = row["zero3 mesh"], row["mesh"]
            print(f"serve_mesh {arch} under zero3 ({cfg.n_layers} layers, "
                  f"bf16, mesh {{data 1, model 1}} on nccl): tokens equal "
                  f"to the steps without a mesh; prefill "
                  f"{z['prefill_tokens_per_s']:.0f} tokens/s "
                  f"({b * t / z['prefill_tokens_per_s'] * 1e3:.1f} ms), "
                  f"tick {z['decode_tick_ms']:.2f} ms, peak "
                  f"{z['peak_gib']:.2f} GiB; the 2d mesh run beside it: "
                  f"{m['prefill_tokens_per_s']:.0f} tokens/s "
                  f"({b * t / m['prefill_tokens_per_s'] * 1e3:.1f} ms), "
                  f"tick {m['decode_tick_ms']:.2f} ms; launches: flash "
                  f"{launches['zero3 mesh']['flash']}, scan "
                  f"{launches['zero3 mesh']['scan']} [{card}]", flush=True)
        recurrent = any("rglru" in unit for unit, _ in cfg.stacks)
        attends = any(ATTENTION_BLOCKS & set(unit) for unit, _ in cfg.stacks)
        if ((launches["mesh"]["flash"] > 0) != attends
                or (launches["mesh"]["scan"] > 0) != recurrent
                or any(n != launches["no mesh"] for n in launches.values())):
            raise AssertionError(
                f"serve_mesh {arch}: launches {launches}: flash must launch "
                f"exactly where the model attends, the scan exactly where "
                f"it has the RG-LRU, and both as often on each mesh as "
                f"without one")
        del params, runs, specs, warm
        gc.collect()
        torch.cuda.empty_cache()
    archs = [arch for arch, _ in SERVE_MESH]
    res["flash_launches"] = sum(res[a]["launches_serve_mesh"]["flash"]
                                for a in archs)
    res["scan_launches"] = sum(res[a]["launches_serve_mesh"]["scan"]
                               for a in archs)
    print(f"serve_mesh: {res['flash_launches']} flash and "
          f"{res['scan_launches']} scan launches on the mesh, the "
          f"{len(archs)} models", flush=True)
    return res


# Phase 18: the dry run on the card's machine, and the estimator held to the
# card: (name, shape) of internlm2-1.8b's steps, bf16 parameters as the
# dry run's.  Train at phase 13's B 8, T 256 (+1 for the labels).
DRYRUN_CELLS = (("train", (257, 8, "train")), ("prefill", (256, 8, "prefill")),
                ("decode", (4096, 8, "decode")))


def dryrun_cli(card) -> dict:
    """Phase 18a: ``python -m repro_torch.launch.dryrun`` for xlstm-350m
    decode_32k on the multi-pod mesh, in a subprocess (a fake group of 512
    ranks, meta tensors): status ok, 512 ranks."""
    import tempfile
    import os
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "xlstm-350m", "--shape", "decode_32k", "--multi-pod", "--out",
             out], capture_output=True, text=True, timeout=600, cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"dryrun CLI exit {proc.returncode}: "
                                 f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
        rec = json.loads((Path(out) / "xlstm-350m__decode_32k__pod2x16x16"
                          ".json").read_text())
    if rec["status"] != "ok" or rec["n_devices"] != 512:
        raise AssertionError(f"dryrun record: {rec}")
    mem, coll = rec["memory"], rec["collectives"]
    gib = (mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]) / 2 ** 30
    counts = {c: coll[f"{c}_count"] for c in ("all-reduce", "all-gather",
                                              "reduce-scatter", "all-to-all")}
    print(f"dryrun xlstm-350m decode_32k pod2x16x16 (the xLSTM split over "
          f"model 16): status ok, {rec['n_devices']} ranks, per-rank GiB "
          f"{gib:.3f}, flops {rec['cost']['flops']:.4e}, global "
          f"{rec['jaxpr_flops_global']:.4e}, wire bytes {coll['wire_bytes']}"
          f", collectives {counts}, memory argument "
          f"{mem['argument_size_in_bytes']} output "
          f"{mem['output_size_in_bytes']} temp {mem['temp_size_in_bytes']} "
          f"alias {mem['alias_size_in_bytes']} bytes; traced in "
          f"{rec['lower_s']} s ({wall:.1f} s with the process) [{card}]",
          flush=True)
    return {k: rec[k] for k in ("memory", "cost", "collectives",
                                "jaxpr_flops_global", "n_devices",
                                "lower_s")}


def estimator_vs_card(torch, dev, card) -> dict:
    """Phase 18b: internlm2-1.8b's train, prefill and decode steps built by
    ``make_step_and_specs`` on a one-rank (pod 1, data 1, model 1) NCCL
    mesh, traced on meta (flops; memory: the arguments' bytes plus the
    MemTracker peak's temp), then run for real on the card under the flop
    counter: the two counts equal exactly; the estimate printed beside
    ``max_memory_allocated`` of the real step."""
    import gc
    from torch.distributed.device_mesh import init_device_mesh
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.launch.dryrun import local_bytes, trace_step
    from repro_torch.launch.mesh import distribute_tree
    from repro_torch.launch.specs import make_step_and_specs
    from repro_torch.models import init_caches, init_params
    from repro_torch.train.optimizer import init_opt_state
    mesh = init_device_mesh("cuda", (1, 1, 1),
                            mesh_dim_names=("pod", "data", "model"))
    cfg = get_config("internlm2-1.8b")
    res = {}
    for name, (t, b, kind) in DRYRUN_CELLS:
        shape = ShapeSpec(name, t, b, kind)
        step, args, in_pl, _, _ = make_step_and_specs(cfg, shape, mesh)
        grad = torch.enable_grad() if kind == "train" else torch.no_grad()
        placed = tuple(distribute_tree(a, p, mesh)
                       for a, p in zip(args, in_pl))
        t0 = time.perf_counter()
        with grad:
            _, meta_flops, _, peak = trace_step(step, placed)
            temp = peak - local_bytes(placed)
        trace_s = time.perf_counter() - t0
        est = local_bytes(placed) + temp
        del placed, args
        # the same step on the card, from real arguments
        params = init_params(cfg, seed=SEED, dtype=torch.bfloat16,
                             device=dev)
        g = torch.Generator(device=dev).manual_seed(SEED + 18)
        toks = torch.randint(0, cfg.vocab, (b, t if kind != "decode" else 1),
                             generator=g, device=dev, dtype=torch.int32)
        if kind == "train":
            real = (params, init_opt_state(params), {"tokens": toks})
        elif kind == "prefill":
            real = (params, toks, init_caches(cfg, b, t, device=dev))
        else:
            real = (params, toks, torch.full((b,), t - 1, dtype=torch.int32,
                                             device=dev),
                    init_caches(cfg, b, t, device=dev))
        real = tuple(distribute_tree(a, p, mesh) for a, p in zip(real, in_pl))
        flash_attention_cuda.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with grad, FlopCounterMode(display=False) as counter:
            step(*real)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        card_flops = counter.get_total_flops()
        row = {"meta_flops": meta_flops, "card_flops": card_flops,
               "estimate_bytes": est, "argument_bytes": est - temp,
               "temp_bytes": temp, "max_memory_allocated": peak,
               "ratio": est / peak, "trace_s": trace_s,
               "flash_launches": flash_attention_cuda.launches}
        res[name] = row
        print(f"estimator {name} internlm2-1.8b B={b} T={t} bf16 on (pod 1, "
              f"data 1, model 1): flops meta {meta_flops} card {card_flops} "
              f"({'equal' if meta_flops == card_flops else 'DIFFER'}); "
              f"estimate {est / 2 ** 30:.3f} GiB (arguments "
              f"{(est - temp) / 2 ** 30:.3f} + temp {temp / 2 ** 30:.3f}) "
              f"against max_memory_allocated {peak / 2 ** 30:.3f} GiB, "
              f"ratio {est / peak:.3f}; flash launches "
              f"{row['flash_launches']}; traced in {trace_s:.1f} s"
              + (" (phase 13's f32 step: 30.50 GiB)" if kind == "train"
                 else "") + f" [{card}]", flush=True)
        if meta_flops != card_flops or meta_flops <= 0:
            raise AssertionError(f"estimator {name}: meta flops {meta_flops}"
                                 f" != card flops {card_flops}")
        if kind == "prefill" and row["flash_launches"] <= 0:
            raise AssertionError("estimator prefill: the flash op never "
                                 "launched its kernel")
        del real, params
        gc.collect()
        torch.cuda.empty_cache()
    return res


def op_dispatch(torch, dev) -> dict:
    """Phase 9b: what the registered ops cost beside the wrappers' direct
    path, at each LM kernel's headline shape: one call by CUDA events, the
    host wall of the launch path, and one call under the profiler (its host
    span), for ``flash_attention`` / ``rglru_scan`` (direct launcher: what
    the model calls) and ``flash_attention_op`` / ``rglru_scan_op`` (the
    dispatcher, then the same launcher: what a flop counter or a memory
    tracker sees)."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_op)
    from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_op
    name, b, h, hkv, tq, s, hd, dt, kw = FLASH_CASES[0]
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    q, k, v = (torch.randn(shape, generator=g, device=dev).to(
        getattr(torch, dt)) for shape in ((b, h, tq, hd), (b, hkv, s, hd),
                                          (b, hkv, s, hd)))
    _, rb, rt, rw, _ = RGLRU_CASES[0]
    u = torch.randn((rb, rt, rw), generator=g, device=dev)
    a = torch.rand((rb, rt, rw), generator=g, device=dev)
    h0 = torch.randn((rb, rw), generator=g, device=dev)
    fns = {
        "flash_attention": (
            lambda: flash_attention(q, k, v, **kw),
            lambda: flash_attention_op(q, k, v, kw.get("causal", True),
                                       kw.get("window"), kw.get("softcap"),
                                       None), "flash"),
        "rglru_scan": (lambda: rglru_scan(u, a, h0),
                       lambda: rglru_scan_op(u, a, h0), "rglru_scan")}
    res = {}
    for kernel, (direct, op, pattern) in fns.items():
        row = {}
        for label, fn in (("direct", direct), ("op", op), ("op 2", op),
                          ("direct 2", direct)):
            row[label] = {"ms": median_ms(torch, fn),
                          "host_us": host_us(torch, fn),
                          "host_span_us": one_call_profile(
                              torch, fn, pattern)["host_span_us"]}
        res[kernel] = row
        print(f"{kernel} one call, direct / registered op / op / direct "
              f"(CUDA events ms; launch path host us; host span under the "
              f"profiler us): " + "; ".join(
                  f"{lab} {r['ms']:.4f} ms, {r['host_us']:.1f} us, "
                  f"{fmt_us(r['host_span_us'])} us" for lab, r in row.items()),
              flush=True)
    return res


# the in-place cell's shard: the fifth of nine equal cuts of the 2^24-key
# Weblogs column (fitbench's generator, seed 0), error 64, buffers of 16,
# 1,820 inserts a publish (16,384 over nine shards), 3/4 copies of its keys
REFIT_COLUMN = 2 ** 24
REFIT_CUT = (4, 9)
REFIT_INSERTS = 1820
REFIT_PUBLISHES = 4


def flush_per_segment(tree) -> int:
    """The flush before the batched one: one merge and one
    ``shrinking_cone`` call a dirty segment (``_refit_run``), one splice."""
    dirty = tree.dirty_segments()
    tree._splice({sid: tree._replacement(*tree._refit_run(
        tree.pages[sid], tree.buffers[sid], None, tree.buf_payloads[sid]))
        for sid in dirty})
    tree._flat_cache = tree._table_cache = None
    return len(dirty)


def refit_phase(torch, dev, card) -> dict:
    """The batched ShrinkingCone at the in-place cell's shape: one shard's
    dirty runs before its fourth publish, fitted by the kernel (one call,
    in bursts, the profiler's kernel time) beside its bound and its twin,
    then the whole ``flush`` three ways on copies of the one tree: the
    per-segment path, the batched flush on the host, the batched flush on
    the card; all three trees must be equal."""
    import copy

    from fitbench import keys as K
    from fitbench.datasets import weblogs_like
    from repro_torch.core.tree import FITingTree
    from repro_torch.kernels import shrinking_cone as sc
    t0 = time.perf_counter()
    column = K.integer_column(torch, weblogs_like.generate(
        torch, REFIT_COLUMN, SEED, dev), REFIT_COLUMN)
    a, b = (column.shape[0] * c // REFIT_CUT[1]
            for c in (REFIT_CUT[0], REFIT_CUT[0] + 1))
    shard = column[a:b]
    tree = FITingTree(shard, error=64, buffer_size=16, assume_sorted=True)
    rng = np.random.default_rng(SEED + 33)

    def inserts():
        keys = tree.as_table().keys
        c = REFIT_INSERTS * 3 // 4
        new = np.concatenate([keys[rng.integers(0, keys.shape[0], c)],
                              np.floor(rng.uniform(shard[0], shard[-1],
                                                   REFIT_INSERTS - c))])
        rng.shuffle(new)
        return new

    for _ in range(REFIT_PUBLISHES - 1):
        tree.insert_many(inserts())
        tree.flush(dev)
    tree.insert_many(inserts())
    dirty = tree.dirty_segments()
    merged, _, off = tree._merge_dirty(dirty)
    out = {"shard_keys": int(shard.shape[0]), "segments": tree.n_segments,
           "runs": len(dirty), "run_keys": int(merged.shape[0]),
           "longest_run": int(np.diff(off).max()), "mode": "paper",
           "setup_s": time.perf_counter() - t0}
    host_keys = torch.from_numpy(merged)
    keys_dev = host_keys.to(dev)

    def call():
        return sc.shrinking_cone_runs_cuda(keys_dev, off, tree.err_seg)

    t0 = time.perf_counter()
    want = sc.shrinking_cone_runs_torch(host_keys, off, tree.err_seg)
    out["plain_ms"] = (time.perf_counter() - t0) * 1e3
    got = call()
    torch.cuda.synchronize()
    if not torch.equal(got[0].cpu(), want[0]):
        raise AssertionError("shrinking_cone kernel != its twin on the "
                             "shard's dirty runs")
    out["segments_fitted"] = int(want[0].sum())
    out["ms"] = median_ms(torch, call)
    out["burst_ms"] = burst_ms(torch, call)
    out["device_ms"] = device_ms(torch, call, "shrinking_cone")
    # keys and offsets read once, one flag a key written
    out["bytes"] = 9 * merged.shape[0] + 8 * off.shape[0]
    out["bound_ms"] = out["bytes"] / HBM_BPS * 1e3
    out["bound_by"] = "bytes"
    out["share"] = out["bound_ms"] / out["ms"]
    walls = {"per_segment": [], "host": [], "card": []}
    for _ in range(3):
        trees = [copy.deepcopy(tree) for _ in walls]
        for (name, w), t in zip(walls.items(), trees):
            t0 = time.perf_counter()
            n = (flush_per_segment(t) if name == "per_segment" else
                 t.flush(None if name == "host" else dev))
            w.append((time.perf_counter() - t0) * 1e3)
            if n != len(dirty):
                raise AssertionError(f"{name} flush re-fit {n} runs")
        for t in trees[1:]:
            same = (np.array_equal(t.start_keys, trees[0].start_keys)
                    and np.array_equal(t.slopes.view(np.int64),
                                       trees[0].slopes.view(np.int64))
                    and len(t.pages) == len(trees[0].pages)
                    and all(np.array_equal(x, y)
                            for x, y in zip(t.pages, trees[0].pages)))
            if not same:
                raise AssertionError("the batched flush left another tree "
                                     "than the per-segment flush")
    out["flush_ms"] = {k: float(np.median(v)) for k, v in walls.items()}
    print(f"refit: shard of {out['shard_keys']} keys, {out['segments']} "
          f"segments, {out['runs']} dirty runs of {out['run_keys']} keys "
          f"(longest {out['longest_run']}) -> {out['segments_fitted']} "
          f"segments; kernel one call {fmt_ms(out['ms'])} ms, bursts "
          f"{fmt_ms(out['burst_ms'])}, profiler {fmt_ms(out['device_ms'])}, "
          f"bound {out['bound_ms']:.4f} ({out['share']:.1%}), twin "
          f"{out['plain_ms']:.1f} ms; flush per segment "
          f"{out['flush_ms']['per_segment']:.1f} ms, batched on the host "
          f"{out['flush_ms']['host']:.1f}, on the card "
          f"{out['flush_ms']['card']:.1f} (medians of 3, trees equal) "
          f"[{card}]", flush=True)
    return out


def build_all(_build) -> None:
    """Compile every kernel source at once (one nvcc each, in parallel) and
    print ptxas's register and spill report."""
    from concurrent.futures import ThreadPoolExecutor
    names = ("fitting_lookup", "flash_attention", "rglru_scan",
             "shrinking_cone")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(_build.build, names)))
    print(f"build: {', '.join(n + '.cu' for n in names)} in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, lib in libs.items():
        print(f"  {name} -> {lib.name}")
        for line in lib.with_suffix(".log").read_text().splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling",
                                       "arning")):
                print(f"  ptxas: {line.strip()}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.index import Snapshot
    from repro_torch.index.engine import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.kernels.fitting_lookup import fitting_search_cuda

    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}",
          flush=True)
    dev = resolve_device()

    build_all(_build)

    t0 = time.perf_counter()
    keys = make_keys()
    print(f"data: {keys.shape[0]} keys, {np.unique(keys).shape[0]} distinct, "
          f"in [{keys[0]:.0f}, {keys[-1]:.0f}] ({time.perf_counter() - t0:.2f} s)")
    snapshots = {}
    for e in ERRORS:
        t0 = time.perf_counter()
        snapshots[e] = Snapshot.from_arrays(keys, e, assume_sorted=True)
        print(f"fit: e={e}: {snapshots[e].table.n_segments} segments "
              f"({time.perf_counter() - t0:.2f} s)", flush=True)

    flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device=dev)  # 128 MB
    l2_bps = l2_read_rate(torch, dev)
    print(f"L2 read rate (sum over a 16 MB resident tensor, 64 times): "
          f"{l2_bps / 1e12:.3f} TB/s")
    fused, cases = kernel_vs_plain(torch, dev, snapshots, keys, flush,
                                   l2_bps)
    del flush
    parts = breakdown(torch, dev, snapshots[HEADLINE[0]], keys)

    fitting_search_cuda.launches = 0
    t0 = time.perf_counter()
    timings = read_path(torch, snapshots, keys)
    launches = fitting_search_cuda.launches
    print(f"read path: {len(timings)} (e, batch, backend) cells equal; "
          f"{launches} fused kernel launches "
          f"({time.perf_counter() - t0:.1f} s)")
    if launches <= 0:
        raise AssertionError("the read path never launched fitting_search")

    from repro_torch.kernels.shrinking_cone import shrinking_cone_runs_cuda
    refit = refit_phase(torch, dev, card)
    shrinking_cone_runs_cuda.launches = 0
    fitting_search_cuda.launches = 0
    t0 = time.perf_counter()
    writes = write_path(torch, dev, keys, card)
    refit["launches_write_path"] = shrinking_cone_runs_cuda.launches
    if refit["launches_write_path"] <= 0:
        raise AssertionError("the write path's publishes never launched "
                             "shrinking_cone")
    write_launches = fitting_search_cuda.launches
    writes["s"] = time.perf_counter() - t0
    print(f"write path: {write_launches} fused kernel launches "
          f"({writes['s']:.1f} s) [{card}]", flush=True)
    if write_launches <= 0:
        raise AssertionError("the write path never launched fitting_search")

    fitting_search_cuda.launches = 0
    t0 = time.perf_counter()
    lsm = lsm_phase(torch, dev, keys, card)
    lsm_launches = fitting_search_cuda.launches
    lsm["s"] = time.perf_counter() - t0
    print(f"lsm: {lsm_launches} fused kernel launches ({lsm['s']:.1f} s) "
          f"[{card}]", flush=True)
    if lsm_launches <= 0:
        raise AssertionError("the LSM never launched fitting_search")
    fitting_search_cuda.launches = 0
    t0 = time.perf_counter()
    pipeline = pipeline_phase(torch, dev, keys, card)
    pipe_launches = fitting_search_cuda.launches
    pipeline["s"] = time.perf_counter() - t0
    print(f"pipeline: {pipe_launches} fused kernel launches "
          f"({pipeline['s']:.1f} s) [{card}]", flush=True)
    if pipe_launches <= 0:
        raise AssertionError("the pipeline never launched fitting_search")
    fitting_search_cuda.launches = 0
    t0 = time.perf_counter()
    plane = device_plane_phase(torch, dev, keys, card,
                               writes["sharded_search_ms"][Q_KERNEL])
    plane_launches = fitting_search_cuda.launches
    plane["s"] = time.perf_counter() - t0
    print(f"device plane: {plane_launches} fused kernel launches "
          f"({plane['s']:.1f} s) [{card}]", flush=True)
    if plane_launches <= 0:
        raise AssertionError("the device plane never launched "
                             "fitting_search")

    flash_cases = flash_vs_plain(torch, dev)
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    flash_attention_cuda.launches = 0
    t0 = time.perf_counter()
    flash_tp = flash_tp_shapes(torch, dev, card)
    flash_tp_launches = flash_attention_cuda.launches
    print(f"flash at tp {FLASH_TP}: {len(flash_tp)} per-rank shapes, "
          f"{flash_tp_launches} launches ({time.perf_counter() - t0:.1f} s) "
          f"[{card}]", flush=True)
    rglru_cases = rglru_vs_plain(torch, dev)
    from repro_torch.kernels.rglru_scan import (rglru_scan_backward_cuda,
                                                rglru_scan_cuda)
    rglru_scan_cuda.launches = rglru_scan_backward_cuda.launches = 0
    t0 = time.perf_counter()
    scan_tp = rglru_tp_shapes(torch, dev, card)
    scan_tp_launches = {"forward": rglru_scan_cuda.launches,
                        "backward": rglru_scan_backward_cuda.launches}
    print(f"scan at tp {RGLRU_TP}: {len(scan_tp)} per-rank shapes, "
          f"{scan_tp_launches} launches ({time.perf_counter() - t0:.1f} s) "
          f"[{card}]", flush=True)
    dispatch = op_dispatch(torch, dev)
    lm_consistency(torch, dev)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    consistency = arch_consistency(torch, dev)
    print(f"architecture consistency: {len(consistency)} configs "
          f"({time.perf_counter() - t0:.1f} s) [{card}]", flush=True)
    lm_launches, serving = lm_serving(torch, dev)
    t0 = time.perf_counter()
    archs = arch_serving(torch, dev, card)
    print(f"architecture serving: {len(archs)} configs "
          f"({time.perf_counter() - t0:.1f} s) [{card}]", flush=True)
    flash_by_arch = {ARCH: lm_launches["flash_attention"],
                     **{a: r["flash_launches"] for a, r in archs.items()}}

    import torch.distributed as dist
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.rglru_scan import (rglru_scan_backward_cuda,
                                                rglru_scan_cuda)
    from repro_torch.launch.mesh import init_ranks
    init_ranks(dev)
    print(f"training: a one-rank {dist.get_backend()} process group on "
          f"{dev}; every phase below trains on a (data 1, model 1) mesh",
          flush=True)
    flash_attention_cuda.launches = rglru_scan_cuda.launches = 0
    rglru_scan_backward_cuda.launches = 0
    training = {"train_main": train_cli(torch, TRAIN_ARGV, card,
                                        "train_main", TRAIN_PROFILE_STEP)}
    if flash_attention_cuda.launches or rglru_scan_cuda.launches or \
            rglru_scan_backward_cuda.launches:
        raise AssertionError("train_main launched a kernel of a model it "
                             "does not train (flash or the scan)")
    training["train_rglru"] = train_rglru(torch, dev, card)
    training["train_xlstm"] = train_cli(torch, XLSTM_ARGV, card,
                                        "train_xlstm")
    training["train_moe"] = train_moe(torch, card)
    training["train_resume"] = train_resume(torch, card)
    t0 = time.perf_counter()
    served_mesh = serve_mesh(torch, dev, card)
    served_mesh["s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dryrun = {"cli": dryrun_cli(card),
              "estimator": estimator_vs_card(torch, dev, card)}
    dryrun["s"] = time.perf_counter() - t0
    print(f"serve_mesh {served_mesh['s']:.1f} s, dryrun {dryrun['s']:.1f} s "
          f"[{card}]", flush=True)
    dist.destroy_process_group()
    scan_train = training["train_rglru"]

    head = next(c for c in fused if (c["error"], c["mode"])
                == (HEADLINE[0], f"search-{HEADLINE[1]}"))
    window_head = next(c for c in cases
                       if (c["error"], c["side"]) == HEADLINE)
    entry = {
        "name": "fitting_lookup", "route": "cuda",
        "source": "src/repro_torch/csrc/fitting_lookup.cu",
        "replaces": "src/repro/kernels/fitting_lookup.py:57",
        "design": "fused route + predict + window + snap in one launch, "
                  "a thread a query, the window bisected a 32-byte sector "
                  "at a time",
        "launches": launches + write_launches + lsm_launches
        + pipe_launches + plane_launches,
        "launches_by_path": {"read path": launches,
                             "write path": write_launches,
                             "lsm": lsm_launches, "pipeline": pipe_launches,
                             "device plane": plane_launches},
        "max_abs_err": max(
            c["max_abs_err"] for c in fused + cases),
        "equal": all(c["max_abs_err"] == 0 for c in fused) and all(
            c["found_mismatches"] == 0 for c in cases),
        **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "device_ms",
                                "library_device_ms")},
        "window_only_ms": window_head["ms"],
        "headline": {"error": HEADLINE[0], "mode": head["mode"],
                     "n": N_KEYS, "q": Q_KERNEL},
        "breakdown": parts, "fused": fused, "cases": cases,
    }
    refit_entry = {
        "name": "shrinking_cone", "route": "cuda",
        "source": "src/repro_torch/csrc/shrinking_cone.cu",
        "replaces": "none (the JAX package fits on the host: "
                    "src/repro/core/segmentation.py shrinking_cone)",
        "design": "a warp a run, 32 keys a step, the cone by shuffle "
                  "scans, the break by ballot",
        "launches": refit["launches_write_path"],
        "equal": True,
        **{k: refit[k] for k in ("ms", "burst_ms", "device_ms", "plain_ms",
                                 "bound_ms", "bound_by", "share",
                                 "flush_ms")},
        "headline": {k: refit[k] for k in ("runs", "run_keys",
                                           "longest_run", "mode")},
    }
    flash_head = flash_cases[0]
    lm_entries = [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:71",
        "design": "bf16 hd 64-256: TMA K/V ring + wgmma, warp-specialised "
                  "(2 consumer warpgroups, 1 producer); f32 and hd 16/32: "
                  "CUDA-core f32",
        "launches": sum(flash_by_arch.values())
        + served_mesh["flash_launches"],
        "launches_by_arch": flash_by_arch,
        "launches_serve_mesh": served_mesh["flash_launches"],
        "launches_serve_mesh_by_arch": {
            a: served_mesh[a]["launches_serve_mesh"]["flash"]
            for a, _ in SERVE_MESH},
        "dispatch": dispatch["flash_attention"],
        "max_abs_err": flash_head["max_abs_err"], "equal": True,
        **{k: flash_head[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")},
        "headline": {k: flash_head[k] for k in ("case", "b", "h", "hkv",
                                                "tq", "s", "hd", "dtype")},
        "cases": flash_cases,
        "tp16_launches": flash_tp_launches,
        "tp16_shapes": flash_tp,
    }, {
        "name": "rglru_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan.py:37",
        "design": RGLRU_DESIGN,
        "launches": lm_launches["rglru_scan"]
        + scan_train["forward_launches"] + served_mesh["scan_launches"],
        "dispatch": dispatch["rglru_scan"],
        "launches_by_phase": {
            "serving": lm_launches["rglru_scan"],
            "serve_mesh": served_mesh["scan_launches"],
            "train_rglru forward": scan_train["forward_launches"]},
        "launches_by_path": lm_launches["rglru_scan_by_path"],
        "backward": {
            "name": "rglru_scan_backward", "route": "cuda",
            "source": "src/repro_torch/csrc/rglru_scan.cu",
            "replaces": "src/repro/models/blocks.py:420 (_rglru_scan_bwd: "
                        "XLA's reverse associative scan, no Pallas kernel)",
            "design": RGLRU_BWD_DESIGN,
            "launches": scan_train["backward_launches"],
            "launches_by_path": scan_train["backward_launches_by_path"],
            "max_abs_err": max(c["max_abs_err"]
                               for c in scan_train["backward"]["shapes"]),
            "equal": True,
            **{k: scan_train["backward"]["shapes"][0][k]
               for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                         "library_ms", "burst_ms", "old_ms", "autograd_ms",
                         "share")},
            "training_step_check": scan_train["recorded"],
            "shapes": scan_train["backward"]["shapes"]},
        "max_abs_err": max(c["max_abs_err"] for c in rglru_cases),
        "equal": True,
        **{k: rglru_cases[0][k] for k in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms",
                                          "burst_ms", "unaligned_ms",
                                          "share")},
        "headline": {k: rglru_cases[0][k] for k in ("b", "t", "w", "path")},
        "tp16_launches": scan_tp_launches,
        "tp16_shapes": scan_tp,
        "cases": [{k: c[k] for k in ("case", "b", "t", "w", "h0", "path",
                                     "max_abs_err", "ms", "burst_ms",
                                     "host_us", "unaligned_ms",
                                     "unaligned_burst_ms", "plain_ms",
                                     "bound_ms", "share", "burst_share",
                                     "one_call_profile")}
                  for c in rglru_cases],
    }]
    print(json.dumps({"write_path": writes}))
    print(json.dumps({"lsm": lsm, "pipeline": pipeline}))
    print(json.dumps({"device_plane": plane}))
    print(json.dumps({"serving": serving}))
    print(json.dumps({"arch_consistency": consistency,
                      "arch_serving": archs}))
    print(json.dumps({"training": training}))
    print(json.dumps({"serve_mesh": served_mesh, "dryrun": dryrun}))
    print("earlier designs at the headline shapes, copied from PERF.md §6 "
          "(H100 80GB HBM3 at 700 W), not measured in this run: "
          + "; ".join(f"{name} {ms} ms ({what}), {new:.4f} ms in this run"
                      for (name, (ms, what)), new in zip(
                          EARLIER_MS.items(),
                          (entry["ms"], lm_entries[0]["ms"],
                           lm_entries[1]["ms"]))))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(f"card: {card}")
    print(json.dumps({"kernels": [entry, refit_entry, *lm_entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
