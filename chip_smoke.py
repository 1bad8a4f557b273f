#!/usr/bin/env python3
"""Smoke test of the torch port on one CUDA card: the learned-index read path.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It imports only the port (``src/repro_torch``), never JAX or the JAX package,
and fails (non-zero exit, no result line) where no CUDA card is present or
the port's sources are missing.  Phases, each of which raises on failure:

1. The card: name and power limit (``nvidia-smi``), torch and CUDA versions.
2. The build: compile ``csrc/fitting_lookup.cu`` with ``nvcc`` for sm_90a
   and print ``ptxas``'s register/spill report.
3. The data: ``iot_like(2**23)`` keys, rescaled to [0, 2^23] and floored to
   integers (exact in f32; duplicates stay), a 32 MB f32 column on the card,
   fitted at each error e in {16, 64, 256} through ``Snapshot.from_arrays``.
4. Kernel vs plain: at Q = 2^20 queries per e and side, the CUDA window
   kernel against its plain torch twin on the card (exact equality of rank
   and found), each timed with CUDA events (median of 25 after warm-up, L2
   warm and flushed), beside ``torch.searchsorted`` as the library yardstick,
   the work's bound, and an L2 estimate: the 32-byte sectors the windows
   fetch over the L2 read rate a resident reduction reaches.  Then the
   breakdown of one 2^20-query search on the cuda backend: route, kernel,
   duplicate snap (its host sync included) and the engine call's host wall.
5. The read path: ``ServingHandle.install`` of each snapshot, then batches of
   1, 1,000 and 2^20 queries (3/4 drawn from the column, 1/4 uniform
   integers in [-2^10, 2^24 + 2^10]) through lookup / search (both sides) /
   point / count / range / predecessor / successor on the backends cuda,
   torch-window, torch-bisect and dispatch, every answer checked equal to
   ``np.searchsorted`` on the f32 column.  The kernel's launch count is set
   to 0 just before this phase and read just after; it must be > 0.
6. A ``{"kernels": [...]}`` line, the card line again, and last
   ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
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
    """Phase 4: exact equality and timings at n = 2^23, Q = 2^20."""
    from repro_torch.index.engine import device_index, make_plan, \
        predict_positions
    from repro_torch.kernels.fitting_lookup import (fitting_lookup_cuda,
                                                    fitting_lookup_torch)
    rng = np.random.default_rng(SEED + 1)
    q_host = make_queries(keys, Q_KERNEL, rng)
    cases = []
    for e in ERRORS:
        idx = device_index(snapshots[e].table, dev)
        n = idx.keys.shape[0]
        plan = make_plan(n, e)
        q = torch.tensor(q_host.astype(np.float32), device=dev)
        qlo = (predict_positions(idx, q) - e).clamp(0, plan.n_pad - plan.window)
        args = (idx.keys, q, qlo)
        kw = {"window": plan.window, "n_pad": plan.n_pad}
        covered = covered_keys(torch, qlo, plan.window, n)
        l2_bytes = 32 * l2_sectors(torch, qlo, plan.window, n)
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
            ops = 2 * Q_KERNEL * plan.window        # one order, one equality
            byte_ms, op_ms = nbytes / HBM_BPS * 1e3, ops / F32_OPS * 1e3
            cases.append({
                "error": e, "side": side, "window": plan.window,
                "max_abs_err": err, "found_mismatches": flags,
                "ms": ms, "cold_ms": cold_ms, "plain_ms": plain_ms,
                "library_ms": lib_ms, "bound_ms": max(byte_ms, op_ms),
                "bound_by": "bytes" if byte_ms >= op_ms else "operations",
                "dram_bytes": nbytes, "ops": ops, "covered_keys": covered,
                "l2_bytes": l2_bytes, "l2_ms": l2_bytes / l2_bps * 1e3,
            })
            print(f"kernel e={e:3d} {side:5s} W={plan.window:3d}: equal; "
                  f"kernel {ms:.4f} ms (L2 flushed {cold_ms:.4f}), plain "
                  f"{plain_ms:.4f} ms, searchsorted {lib_ms:.4f} ms, bound "
                  f"{max(byte_ms, op_ms):.4f} ms, L2 estimate "
                  f"{cases[-1]['l2_ms']:.4f} ms ({l2_bytes / 1e6:.0f} MB of "
                  f"sectors)", flush=True)
    return cases


def l2_read_rate(torch, dev) -> float:
    """Achieved L2 read rate (bytes/s): one reduction reads a 16 MB
    L2-resident tensor 64 times over (a stride-0 view, nothing copied)."""
    x = torch.ones(4 * 2 ** 20, dtype=torch.float32, device=dev)
    rows = x.expand(64, -1)
    ms = median_ms(torch, lambda: rows.sum(1), warmup=5)
    return rows.numel() * 4 / (ms * 1e-3)


def breakdown(torch, dev, snapshot, keys):
    """Where one search(left) of Q = 2^20 queries goes on the cuda backend at
    the headline error: route + clamp, the kernel, the duplicate snap (with
    its host sync), all of ``kernel_search`` on device tensors (device
    time, CUDA events), and the engine call from and to host arrays (host
    wall, copies included)."""
    from repro_torch.index import make_engine
    from repro_torch.index.engine import (kernel_search, make_plan,
                                          predict_positions, snap_side)
    from repro_torch.kernels.fitting_lookup import fitting_lookup_cuda
    e = HEADLINE[0]
    eng = make_engine(snapshot.table, "cuda", device=dev)
    idx = eng.index
    q_host = make_queries(keys, Q_KERNEL, np.random.default_rng(SEED + 3))
    q = torch.tensor(q_host.astype(np.float32), device=dev)
    plan = make_plan(idx.keys.shape[0], e)

    def route():
        return (predict_positions(idx, q) - e).clamp(0, plan.n_pad
                                                     - plan.window)

    def kernel():
        return fitting_lookup_cuda(idx.keys, q, qlo, window=plan.window,
                                   n_pad=plan.n_pad, side="left")

    qlo = route()
    rank = kernel()[0]
    final = snap_side(idx.keys, q, rank, "left")
    parts = {"error": e, "q": Q_KERNEL,
             "snapped": int((final != rank).sum()),
             "route_ms": median_ms(torch, route),
             "kernel_ms": median_ms(torch, kernel),
             "snap_ms": median_ms(torch, lambda: snap_side(idx.keys, q, rank,
                                                           "left")),
             "kernel_search_ms": median_ms(torch, lambda: kernel_search(
                 idx, q, "left"))}
    walls = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        eng.search(q_host, "left")
        walls.append((time.perf_counter() - t0) * 1e3)
    parts["engine_search_wall_ms"] = float(np.median(walls))
    print("breakdown of search(left), cuda, e={error}, Q={q}: route "
          "{route_ms:.4f} ms, kernel {kernel_ms:.4f} ms, snap "
          "{snap_ms:.4f} ms ({snapped} queries snapped), kernel_search "
          "{kernel_search_ms:.4f} ms device; engine.search "
          "{engine_search_wall_ms:.3f} ms host wall".format(**parts),
          flush=True)


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
    from repro_torch.kernels.fitting_lookup import fitting_lookup_cuda

    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}",
          flush=True)
    dev = resolve_device()

    t0 = time.perf_counter()
    lib = _build.build("fitting_lookup")
    print(f"build: fitting_lookup.cu in {time.perf_counter() - t0:.2f} s "
          f"-> {lib.name}")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

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
    cases = kernel_vs_plain(torch, dev, snapshots, keys, flush, l2_bps)
    del flush
    breakdown(torch, dev, snapshots[HEADLINE[0]], keys)

    fitting_lookup_cuda.launches = 0
    t0 = time.perf_counter()
    timings = read_path(torch, snapshots, keys)
    launches = fitting_lookup_cuda.launches
    print(f"read path: {len(timings)} (e, batch, backend) cells equal; "
          f"{launches} kernel launches ({time.perf_counter() - t0:.1f} s)")
    if launches <= 0:
        raise AssertionError("the read path never launched fitting_lookup")

    head = next(c for c in cases if (c["error"], c["side"]) == HEADLINE)
    entry = {
        "name": "fitting_lookup", "route": "cuda",
        "source": "src/repro_torch/csrc/fitting_lookup.cu",
        "replaces": "src/repro/kernels/fitting_lookup.py:57",
        "launches": launches, "max_abs_err": max(c["max_abs_err"]
                                                 for c in cases),
        "equal": all(c["max_abs_err"] == 0 and c["found_mismatches"] == 0
                     for c in cases),
        "ms": head["ms"], "kernel_ms": head["ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        "headline": {"error": HEADLINE[0], "side": HEADLINE[1],
                     "n": N_KEYS, "q": Q_KERNEL},
        "cases": cases,
    }
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(f"card: {card}")
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
