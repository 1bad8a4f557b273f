"""Sec. 6 cost model: pick the error threshold from a latency SLA or space budget.

Port of ``repro.core.cost_model``.  The paper's two models (Eq. 1 latency and
size, the choosers, the segments-curve learner) and the host ``calibrate`` are
copied unchanged.  The device profile is the CUDA card's: :class:`GPUCostParams`
prices the port's two device tiers, ``torch-bisect`` (a few dozen torch ops
and one host sync a batch) and ``cuda`` (one launch of the fused search
kernel), with the reference's formulas, so the same numbers give the same
tier curves, crossings and exchange costs.  Its defaults were measured on the
card by :func:`calibrate_device`.

Host-only: numpy and the port's segmentation, no torch at module scope
(``calibrate_device`` imports the engines when it runs).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Sequence

import numpy as np

from .segmentation import shrinking_cone


@dataclasses.dataclass(frozen=True)
class CostParams:
    c_ns: float = 50.0        # random-access / cache-miss penalty (paper Sec. 7.4: 50ns)
    fanout: int = 16          # b, router fanout
    fill: float = 0.5         # f, tree fill ratio (Sec. 6.2)
    buffer_size: int = 16     # buff
    scan_ns_per_row: float = 0.5  # sequential page-scan marginal (range queries)


@dataclasses.dataclass(frozen=True)
class GPUCostParams:
    """The device profile of one CUDA card, in the reference's roofline form:
    a lookup pays a fixed device latency, a router step per level, and its
    +-error window at the memory rate; a batch pays a launch on top.

    Every default but ``bytes_per_key`` (the f32 key column's width) was
    measured by ``calibrate_device`` on the 2^23-key ``iot_like`` column at
    e = 64 (``chip_smoke.py``'s write-path phase) on an NVIDIA H100 80GB
    HBM3 at a 700 W power limit; PERF.md names the run.  The tiers are timed
    by host wall, host arrays in and out, so the rates are the engines'
    whole calls, copies included, not the kernel's."""
    # H100 80GB HBM3, 700 W: 520 window bytes over the cuda tier's marginal
    # host wall per query
    hbm_gbps: float = 120.36
    # H100 80GB HBM3, 700 W: CUDA events around one fused search of one
    # query (its launch path and the kernel)
    setup_ns: float = 58_880.0
    # H100 80GB HBM3, 700 W: the torch-bisect tier's marginal per query over
    # its 11 steps (8 halvings, 3 router levels)
    step_ns: float = 0.4627
    bytes_per_key: int = 4        # f32 keys on the card
    # H100 80GB HBM3, 700 W: the torch-bisect tier's fixed host wall less
    # setup_ns
    launch_ns: float = 1_800_780.0
    # H100 80GB HBM3, 700 W: the cuda tier's fixed host wall above
    # torch-bisect's, clamped at 0 (on the card it is below it)
    plan_ns: float = 0.0


# Router levels the device latency model counts: a 16-ary descent over the
# segment start keys, as the host model's fanout; shared by latency_ns_gpu and
# tier_cost_curves so candidate scoring and the dispatch crossings agree.
ROUTER_FANOUT = 16


def latency_ns(error: int, n_segments: int, p: CostParams) -> float:
    """Paper Eq. (1), Sec. 6.1: c * [log_b(S_e) + log2(e) + log2(buff)]."""
    tree = math.log(max(n_segments, 2), p.fanout)
    seg = math.log2(max(error, 2))
    buf = math.log2(max(p.buffer_size, 2))
    return p.c_ns * (tree + seg + buf)


def size_bytes(error: int, n_segments: int, p: CostParams) -> float:
    """Paper Eq. (1), Sec. 6.2: f*S_e*log_b(S_e)*16B + S_e*24B (pessimistic).

    The tree height term is clamped to >= 1 (a one-node tree still stores its
    S_e entries), keeping the bound pessimistic for tiny segment counts."""
    s = max(n_segments, 2)
    return p.fill * s * max(1.0, math.log(s, p.fanout)) * 16.0 + s * 24.0


def latency_ns_gpu(error: int, n_segments: int, p: GPUCostParams,
                   router_levels: int | None = None) -> float:
    """Device form of Eq. 1: the fixed device latency + router steps + the
    +-error window streamed at the memory rate."""
    levels = router_levels or max(1, math.ceil(
        math.log(max(n_segments, 2), ROUTER_FANOUT)))
    window_bytes = (2 * error + 2) * p.bytes_per_key
    return p.setup_ns + levels * p.step_ns + window_bytes / p.hbm_gbps


# ----------------------------------------------------------- range-scan model
def scan_ns_per_row_gpu(p: GPUCostParams) -> float:
    """Sequential scan marginal on the card: rows stream at the memory rate."""
    return p.bytes_per_key / p.hbm_gbps


def range_latency_ns(error: int, n_segments: int, p: CostParams,
                     scan_rows: float) -> float:
    """Range-scan latency: the clustered layout answers a range with one
    predecessor search (the paper's Eq. 1 point cost locates the scan start)
    plus a sequential page scan -- fixed predecessor cost + per-row scan
    marginal."""
    return latency_ns(error, n_segments, p) + scan_rows * p.scan_ns_per_row


def range_latency_ns_gpu(error: int, n_segments: int, p: GPUCostParams,
                         scan_rows: float) -> float:
    """Device form of :func:`range_latency_ns`: predecessor + streamed rows."""
    return (latency_ns_gpu(error, n_segments, p)
            + scan_rows * scan_ns_per_row_gpu(p))


def learn_segments_fn(keys: np.ndarray, errors: Sequence[int],
                      sample: int | None = 200_000) -> Callable[[int], int]:
    """Sec. 6: 'learned for a specific dataset' -- segment at each candidate error
    (optionally on a contiguous sample, scaled back up) and interpolate log-log."""
    keys = np.asarray(keys, np.float64)
    scale = 1.0
    if sample is not None and keys.shape[0] > sample:
        scale = keys.shape[0] / sample
        keys = keys[: sample]
    es, ss = [], []
    for e in sorted(set(int(e) for e in errors)):
        segs = shrinking_cone(keys, e)
        es.append(e)
        ss.append(max(1, segs.n_segments) * scale)
    log_e, log_s = np.log(np.array(es, float)), np.log(np.array(ss, float))

    def fn(error: int) -> int:
        le = math.log(max(1, error))
        return int(round(math.exp(np.interp(le, log_e, log_s))))

    return fn


def choose_error_for_latency(l_req_ns: float, segments_fn: Callable[[int], int],
                             candidates: Sequence[int], p: CostParams,
                             latency_fn: Callable[[int, int], float] | None = None
                             ) -> int | None:
    """Sec. 6.1 Eq. (2): smallest-size index meeting the latency requirement.

    ``latency_fn(error, n_segments)`` substitutes a different latency model
    (e.g. the device model :func:`latency_ns_gpu`) while the size side stays
    the paper's Eq. 1 metadata accounting; ``None`` means the paper model."""
    lat = latency_fn or (lambda e, s: latency_ns(e, s, p))
    best, best_size = None, float("inf")
    for e in candidates:
        s = segments_fn(e)
        if lat(e, s) <= l_req_ns:
            sz = size_bytes(e, s, p)
            if sz < best_size:
                best, best_size = e, sz
    return best


def choose_error_for_space(s_req_bytes: float, segments_fn: Callable[[int], int],
                           candidates: Sequence[int], p: CostParams,
                           latency_fn: Callable[[int, int], float] | None = None
                           ) -> int | None:
    """Sec. 6.2 Eq. (2): fastest index within the storage budget.

    ``latency_fn`` as in :func:`choose_error_for_latency`."""
    lat = latency_fn or (lambda e, s: latency_ns(e, s, p))
    best, best_lat = None, float("inf")
    for e in candidates:
        s = segments_fn(e)
        if size_bytes(e, s, p) <= s_req_bytes:
            l = lat(e, s)
            if l < best_lat:
                best, best_lat = e, l
    return best


# ------------------------------------------------------- dispatch tier curves
def tier_cost_curves(error: int, n_segments: int,
                     cpu: CostParams | None = None,
                     gpu: GPUCostParams | None = None,
                     range_fraction: float = 0.0,
                     scan_rows: float = 0.0
                     ) -> dict[str, tuple[float, float]]:
    """Modeled batched-lookup cost per dispatch tier: ``{tier: (fixed_ns,
    per_query_ns)}`` so a batch of ``n`` queries costs ``fixed + n * per``.

    The three tiers of ``repro_torch.index.engine.DispatchEngine``:

    * ``small`` (host numpy): no dispatch cost; each query pays the paper's
      Eq. 1 host latency (:func:`latency_ns`) minus its buffer-scan term --
      the dispatch tiers serve a *published snapshot*, whose lookups never
      touch write-side insert buffers.
    * ``medium`` (torch-bisect): one batch launch plus the device latency up
      front; each query then pays ``log2(2e+2)`` halving steps and the router
      levels at ``step_ns`` each.
    * ``large`` (cuda, the fused kernel): the launch plus ``plan_ns`` up
      front; each query's +-error window then streams at the memory rate.

    ``range_fraction``/``scan_rows`` fold a scan-heavy workload into the
    marginal costs: that fraction of queries additionally scans ``scan_rows``
    rows, at the host's sequential-scan rate on the ``small`` tier and at the
    memory rate on the device tiers, so the crossings shift left as
    ``range_fraction`` grows."""
    cpu = cpu or CostParams()
    gpu = gpu or GPUCostParams()
    steps = math.ceil(math.log2(2 * max(error, 1) + 2))
    window_bytes = (2 * error + 2) * gpu.bytes_per_key
    levels = max(1, math.ceil(
        math.log(max(n_segments, 2), ROUTER_FANOUT)))
    host_ns = (latency_ns(error, n_segments, cpu)
               - cpu.c_ns * math.log2(max(cpu.buffer_size, 2)))
    host_scan = range_fraction * scan_rows * cpu.scan_ns_per_row
    dev_scan = range_fraction * scan_rows * scan_ns_per_row_gpu(gpu)
    return {
        "small": (0.0, host_ns + host_scan),
        "medium": (gpu.launch_ns + gpu.setup_ns,
                   steps * gpu.step_ns + levels * gpu.step_ns + dev_scan),
        "large": (gpu.launch_ns + gpu.setup_ns + gpu.plan_ns,
                  window_bytes / gpu.hbm_gbps + gpu.step_ns + dev_scan),
    }


def curve_crossings(curves: dict[str, tuple[float, float]]) -> tuple[int, int]:
    """``(small_max, large_min)`` where the per-tier affine cost curves cross.

    ``curves`` maps the three ``DispatchEngine`` tiers to ``(fixed_ns,
    per_query_ns)`` pairs -- modeled (:func:`tier_cost_curves`), measured
    (:func:`fit_tier_curves`), or a mixture.  ``small_max`` is the largest
    batch the host tier still wins (the medium tier's fixed launch cost
    amortizes beyond it); ``large_min`` the smallest batch where the large
    tier's extra fixed cost pays for its lower marginal cost.  Degenerate
    slopes (a tier whose marginal cost is not strictly better than its
    predecessor's) push the crossing to the extreme, so the invariant
    ``0 <= small_max < large_min`` always holds."""
    (f_s, p_s), (f_m, p_m), (f_l, p_l) = (
        curves["small"], curves["medium"], curves["large"])
    if p_s > p_m:
        small_max = max(1, int((f_m - f_s) / (p_s - p_m)))
    else:                  # host never loses per-query: keep batches on host
        small_max = 1 << 30
    if p_m > p_l:
        large_min = max(small_max + 1, int(math.ceil((f_l - f_m) / (p_m - p_l))))
    else:                  # the kernel never wins per-query: effectively disabled
        large_min = max(small_max + 1, 1 << 31)
    return small_max, large_min


def dispatch_thresholds(error: int, n_segments: int,
                        cpu: CostParams | None = None,
                        gpu: GPUCostParams | None = None,
                        range_fraction: float = 0.0,
                        scan_rows: float = 0.0) -> tuple[int, int]:
    """Cost-model-calibrated ``(small_max, large_min)`` for ``DispatchEngine``:
    the batch sizes where the modeled per-tier latency curves cross (see
    :func:`curve_crossings`).  ``range_fraction``/``scan_rows`` make the
    crossings scan-aware (see :func:`tier_cost_curves`)."""
    return curve_crossings(tier_cost_curves(error, n_segments, cpu, gpu,
                                            range_fraction, scan_rows))


# ------------------------------------------- device-plane exchange strategies
def exchange_cost_ns(strategy: str, batch: int, n_devices: int, error: int,
                     n_segments: int, p: GPUCostParams | None = None,
                     *, slack: float = 2.0) -> float:
    """Modeled wall cost of one device-sharded ``search`` collective round.

    Two exchange strategies move a batch of queries across ``D`` devices:

    * ``"allgather"``: one gather of the full batch; every device then
      answers all ``batch`` queries against its local shard and a sum
      combines the per-shard ranks.  Cheap to launch, but per-device work
      is the *whole* batch -- it never shrinks as devices are added.
    * ``"a2a"``: queries are bucketed to their owning shard (a prelude,
      ``plan_ns``), exchanged all-to-all, answered locally, and exchanged
      back -- three collective hops, but per-device work is only
      ``slack * batch / D`` queries.

    Per-query search work on a shard is the device model's window cost over
    the shard's (smaller) segment slice; the fixed device latency stays a
    fixed per-hop cost rather than a per-query one."""
    p = p or GPUCostParams()
    d = max(1, n_devices)
    s_local = max(1, math.ceil(max(1, n_segments) / d))
    per_q = latency_ns_gpu(error, s_local, p) - p.setup_ns
    wire = p.bytes_per_key / p.hbm_gbps
    if strategy == "allgather":
        return (p.launch_ns + p.setup_ns + batch * wire + batch * per_q)
    if strategy == "a2a":
        routed = slack * batch / d
        return (p.launch_ns + p.plan_ns
                + 2 * (p.setup_ns + routed * wire) + routed * per_q)
    raise ValueError(f"unknown exchange strategy {strategy!r}")


def choose_exchange(batch: int, n_devices: int, error: int, n_segments: int,
                    p: GPUCostParams | None = None,
                    *, slack: float = 2.0) -> str:
    """Pick the cheaper exchange strategy for a representative batch size.

    Small batches amortize nothing: the a2a path's bucketing prelude and
    extra hops dominate, so ``allgather`` wins.  Past the crossover the
    ``slack/D < 1`` per-device work reduction pays for the hops and ``a2a``
    wins.  On a single device there is nothing to exchange -- allgather
    degenerates to a local search and always wins."""
    if n_devices <= 1:
        return "allgather"
    a = exchange_cost_ns("allgather", batch, n_devices, error, n_segments, p,
                         slack=slack)
    b = exchange_cost_ns("a2a", batch, n_devices, error, n_segments, p,
                         slack=slack)
    return "a2a" if b < a else "allgather"


def exchange_crossover_batch(n_devices: int, error: int, n_segments: int,
                             p: GPUCostParams | None = None,
                             *, slack: float = 2.0,
                             max_batch: int = 1 << 22) -> int | None:
    """Smallest power-of-two batch where ``a2a`` beats ``allgather`` (for
    ``plan().explain()`` audits), or ``None`` if it never does below
    ``max_batch``."""
    if n_devices <= 1:
        return None
    b = 1
    while b <= max_batch:
        if choose_exchange(b, n_devices, error, n_segments, p,
                           slack=slack) == "a2a":
            return b
        b *= 2
    return None


# ----------------------------------------------- measured-curve re-calibration
def fit_tier_curves(samples: dict[str, np.ndarray | Sequence],
                    min_samples: int = 8
                    ) -> dict[str, tuple[float, float]]:
    """Least-squares re-fit of the per-tier affine cost curves from measured
    ``(batch_size, wall_ns)`` samples (e.g. a telemetry ``Monitor``'s
    ``tier.*`` channels): ``{tier: (fixed_ns, per_query_ns)}``.

    To keep one-off spikes (first-call builds, scheduler hiccups) from
    skewing the fixed/marginal split, the line is fit through the *median*
    latency per distinct batch size, weighted by how often that size was
    seen.  Tiers with fewer than ``min_samples`` rows or fewer than two
    distinct batch sizes are omitted -- callers fall back to the modeled
    curve (:func:`tier_cost_curves`) for those.  Coefficients are clamped
    non-negative (a latency curve cannot slope down)."""
    out: dict[str, tuple[float, float]] = {}
    for tier, rows in samples.items():
        a = np.asarray(rows, np.float64).reshape(-1, 2)
        if a.shape[0] < min_samples:
            continue
        sizes = np.unique(a[:, 0])
        if sizes.size < 2:
            continue
        med = np.array([np.median(a[a[:, 0] == s, 1]) for s in sizes])
        wts = np.array([float((a[:, 0] == s).sum()) for s in sizes])
        per, fixed = np.polyfit(sizes, med, 1, w=np.sqrt(wts))
        out[tier] = (max(float(fixed), 0.0), max(float(per), 0.0))
    return out


def refit_params(curves: dict[str, tuple[float, float]],
                 error: int, n_segments: int,
                 cpu: CostParams | None = None,
                 gpu: GPUCostParams | None = None
                 ) -> tuple[CostParams, GPUCostParams]:
    """Invert measured tier curves back into ``(CostParams, GPUCostParams)``.

    The inverse of :func:`tier_cost_curves` at the serving configuration
    ``(error, n_segments)``: each measured coefficient pins the model
    parameter that produces it, so re-running the Sec. 6 planner with the
    returned params reproduces the measured curves (modulo non-negativity
    clamps).  Tiers absent from ``curves`` leave their parameters at the
    prior's value; ``cpu``/``gpu`` default to the module's defaults."""
    cpu = cpu or CostParams()
    gpu = gpu or GPUCostParams()
    steps = math.ceil(math.log2(2 * max(error, 1) + 2))
    window_bytes = (2 * error + 2) * gpu.bytes_per_key
    levels = max(1, math.ceil(
        math.log(max(n_segments, 2), ROUTER_FANOUT)))
    if "small" in curves:
        # host marginal = c_ns * (log_b(S_e) + log2(e)): snapshot lookups pay
        # no buffer-scan term (see tier_cost_curves)
        denom = (math.log(max(n_segments, 2), cpu.fanout)
                 + math.log2(max(error, 2)))
        cpu = dataclasses.replace(
            cpu, c_ns=max(curves["small"][1] / max(denom, 1e-9), 1e-3))
    if "medium" in curves:
        fixed, per = curves["medium"]
        gpu = dataclasses.replace(
            gpu,
            launch_ns=max(fixed - gpu.setup_ns, 0.0),
            step_ns=max(per / (steps + levels), 1e-6))
    if "large" in curves:
        fixed, per = curves["large"]
        gpu = dataclasses.replace(
            gpu,
            plan_ns=max(fixed - gpu.launch_ns - gpu.setup_ns, 0.0),
            hbm_gbps=window_bytes / max(per - gpu.step_ns, 1e-6))
    return cpu, gpu


def calibrate(keys: np.ndarray, engine=None, *,
              errors: Sequence[int] = (16, 256), batch: int = 1024,
              repeats: int = 3, safety: float = 1.3) -> CostParams:
    """One-shot micro-calibration of ``CostParams.c_ns`` against this host.

    Seeds the Sec. 6 latency model from a measurement instead of the paper's
    hand-tuned 50ns constant: builds a published-snapshot table at each
    anchor ``error``, times a ``batch``-sized host lookup (best of
    ``repeats``), and solves Eq. 1 for the ``c_ns`` that reproduces it --
    ``measured_per_query = c_ns * (log_b(S_e) + log2(e))`` (no buffer term:
    snapshots carry no insert buffer).  The worst anchor times ``safety``
    keeps the model an upper bound across the error sweep, which is what
    planner SLA admission (``choose_error_for_latency``) needs.

    ``engine`` substitutes a lookup callable ``engine(queries)`` timed in
    place of the host ``numpy_lookup``; by default the host tier is measured,
    matching the paper's cache-miss model."""
    from repro_torch.index.table import SegmentTable, numpy_lookup  # lazy: no cycle
    keys = np.asarray(keys, np.float64)
    if not np.all(np.diff(keys) >= 0):
        keys = np.sort(keys, kind="stable")
    q = np.resize(keys, max(int(batch), 1))
    worst = 0.0
    for e in sorted(set(int(e) for e in errors)):
        table = SegmentTable.from_keys(keys, e, assume_sorted=True)
        fn = engine if engine is not None else (
            lambda qq, t=table: numpy_lookup(t, qq))
        fn(q)  # warm caches before timing
        best = float("inf")
        for _ in range(max(int(repeats), 1)):
            t0 = time.perf_counter_ns()
            fn(q)
            best = min(best, time.perf_counter_ns() - t0)
        per_query = best / q.size
        denom = (math.log(max(table.n_segments, 2), CostParams.fanout)
                 + math.log2(max(e, 2)))
        worst = max(worst, per_query / max(denom, 1e-9))
    return dataclasses.replace(CostParams(), c_ns=max(worst * safety, 1e-3))


# Batch sizes calibrate_device sweeps, each timed CALIBRATE_REPEATS times:
# eight sizes x 2 = 16 samples a tier, above fit_tier_curves' minimum of 8.
# The sweep reaches 2^20 so that the marginal cost shows past the device
# tiers' fixed costs (milliseconds for torch-bisect).
CALIBRATE_BATCHES = (1, 8, 64, 512, 4096, 32_768, 262_144, 1_048_576)
CALIBRATE_REPEATS = 2


def calibrate_device(keys: np.ndarray, *, device=None, error: int = 64
                     ) -> tuple[CostParams, GPUCostParams]:
    """Measure the dispatch tiers on the card and invert them into params.

    Builds one snapshot table of ``keys`` at ``error``, times ``search`` on
    each tier's engine -- numpy (small), torch-bisect (medium), cuda (large),
    host arrays in and out, as ``DispatchEngine`` records them -- over
    :data:`CALIBRATE_BATCHES` of keys drawn from the column, fits the samples
    with :func:`fit_tier_curves` and inverts the fit with
    :func:`refit_params`.  ``setup_ns``, which the curves do not pin, is the
    device time of one fused launch on one query (CUDA events; the host wall
    of the same call on a CPU device).  ``device=None`` is the CUDA card and
    raises without one.  Returns the calibrated ``(CostParams,
    GPUCostParams)``: the host tier's ``c_ns`` and the device profile."""
    import torch  # lazy: the module stays host-only

    from repro_torch.index.engine import kernel_search, make_engine
    from repro_torch.index.table import SegmentTable

    keys = np.sort(np.asarray(keys, np.float64), kind="stable")
    table = SegmentTable.from_keys(keys, error, assume_sorted=True)
    rng = np.random.default_rng(0)
    engines = {"small": make_engine(table, "numpy"),
               "medium": make_engine(table, "torch-bisect", device=device),
               "large": make_engine(table, "cuda", device=device)}
    samples: dict[str, list] = {tier: [] for tier in engines}
    for b in CALIBRATE_BATCHES:
        q = keys[rng.integers(0, keys.shape[0], b)]
        for tier, eng in engines.items():
            eng.search(q)                      # warm: builds, first launch
            for _ in range(CALIBRATE_REPEATS):
                t0 = time.perf_counter_ns()
                eng.search(q)
                samples[tier].append((b, time.perf_counter_ns() - t0))

    cuda = engines["large"]
    one = torch.tensor(keys[:1].astype(np.float32), device=cuda.device)
    walls = []
    for _ in range(10):
        if cuda.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            kernel_search(cuda.index, one)
            end.record()
            end.synchronize()
            walls.append(start.elapsed_time(end) * 1e6)
        else:
            t0 = time.perf_counter_ns()
            kernel_search(cuda.index, one)
            walls.append(time.perf_counter_ns() - t0)
    prior = GPUCostParams(setup_ns=float(np.median(walls)))
    return refit_params(fit_tier_curves(samples), table.error,
                        table.n_segments, gpu=prior)
