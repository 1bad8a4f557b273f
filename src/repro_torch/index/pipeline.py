"""Async serving pipeline: request coalescing into the fast tier + a
background publish/rebalance cadence.

The Sec. 6 cost model (and the tier curves ``calibrate_device`` measures)
say the same thing: per-query cost collapses when lookups ride the
large-batch tier -- the fixed cost of a call (python dispatch, copies,
kernel launch) amortizes over the batch, and the fused compare-reduce path
has an order-of-magnitude lower marginal cost than the scalar host path.
Yet every caller of ``IndexService.lookup`` pays the tier *their own* batch size earns:
a thousand concurrent callers probing one key each run a thousand scalar
lookups instead of one fused batch of a thousand.

:class:`AsyncIndexService` closes that gap.  It is a front door over any
index service (``IndexService`` / ``ShardedIndexService``) that

* **coalesces**: concurrent callers submit point/search queries into a
  bounded queue (:meth:`lookup_async` / :meth:`search_async`, each returning
  a ``concurrent.futures.Future``); a flusher thread fuses everything queued
  into ONE batch the moment the planned dispatch threshold is reached
  (``flush_threshold``, by default the plan's ``large_min`` -- the batch size
  where the modeled fused-kernel tier latency curve wins) or a deadline
  expires (``max_wait_us``, so a trickle of traffic is never parked forever), then
  scatters per-caller slices back through the futures.  Heavy traffic from
  many small callers therefore lands on the fused large-batch tier
  *naturally*, with per-caller latency bounded by the deadline;
* **maintains**: a daemon cadence thread takes ``publish()`` (a no-op when
  clean) and the ``auto_rebalance`` skew check off the request path, honoring
  the plan's publish cadence (``IndexPlan.publish_every`` -- resolved against
  the spec's expected insert rate into a time interval) instead of running
  re-segmentation inline on whichever unlucky caller's insert trips the
  counter;
* **prewarms**: on start (opt-out via ``prewarm=False``) every serving
  engine and every dispatch tier is built and run once
  (:meth:`DispatchEngine.prewarm`), so the first coalesced batch does not
  eat the device upload or the kernel library's first-use build (``nvcc``)
  as a p99 spike.

Consistency: a fused flush is one ordinary batched call on the underlying
service, so every answer is bit-identical to the caller running the same
batch alone -- coalescing changes *when* work runs, never what it returns.

Failure semantics are loud: an exception inside a fused call fails exactly
the futures of that batch; a crash of the flusher or cadence thread is
recorded and re-raised to every subsequent submitter and to :meth:`close`
(a silently dead maintenance loop is an unbounded staleness bug).

Lifecycle::

    pipe = open_pipeline(keys, FitSpec(latency_budget_ns=500.0))
    f = pipe.lookup_async(qs)          # Future; batch-submit is the same call
    pipe.lookup(qs)                    # sync facade: submit + .result()
    pipe.close()                       # drain in-flight futures, stop threads

or as a context manager (``with open_pipeline(...) as pipe:``).  ``close``
is idempotent; submissions after close raise :class:`PipelineClosed`.

Backpressure: the queue is bounded (``queue_depth`` queries).  A submit
that would overflow it blocks until a flush makes room, up to ``timeout``
(then :class:`PipelineOverloaded`) -- an unbounded queue would just move the
overload into memory and tail latency.  A single submission of
``flush_threshold`` or more queries bypasses the queue entirely and runs
fused inline on the caller's thread: it already earns the fast tier alone,
and parking it would only add deadline latency for no batching win.

Port of ``repro.index.pipeline`` (host code, copied).  On the card the
flusher thread, inline callers and the maintenance thread all reach the
engines; every engine call copies its result to the host, which waits for
its own launches, so the read path adds no stream and no lock of its own
(the reference serialises nothing there either).
"""
from __future__ import annotations

import dataclasses
import threading
import time
import warnings
from concurrent.futures import Future
from typing import TYPE_CHECKING

import numpy as np

from repro_torch.analysis.sanitizer import make_lock

from .telemetry import (CH_FLUSH, CH_QUEUE_DEPTH, CH_SOJOURN, FLUSH_DEADLINE,
                        FLUSH_DRAIN, FLUSH_INLINE, FLUSH_THRESHOLD, Monitor,
                        PipelineMetrics, Replanner, ServiceMetrics)

if TYPE_CHECKING:   # the service types are duck-typed at runtime
    from .fit import FitSpec, IndexPlan

# Fallbacks when neither the caller nor the plan pins a knob.
DEFAULT_FLUSH_THRESHOLD = 1024     # ~ a modeled large_min for mid-size tables
DEFAULT_MAX_WAIT_US = 200.0        # trickle traffic flushes 5000x/s
DEFAULT_QUEUE_DEPTH_FLUSHES = 8    # queue_depth = 8 flushes of headroom


class PipelineClosed(RuntimeError):
    """The pipeline is closed (or its maintenance loop died); see cause."""


class PipelineOverloaded(RuntimeError):
    """The bounded request queue stayed full past the submit timeout."""


class _Request:
    """One caller's queued submission: queries + the future to resolve.
    ``t_enq`` stamps the enqueue time so the flusher can report per-request
    sojourn (queue wait + fused service call) to the monitor."""
    __slots__ = ("queries", "shape", "future", "t_enq")

    def __init__(self, queries: np.ndarray, shape: tuple[int, ...],
                 future: Future):
        self.queries = queries
        self.shape = shape
        self.future = future
        self.t_enq = time.perf_counter_ns()


class AsyncIndexService:
    """Coalescing async front door + maintenance cadence over an index service.

    ``service`` is an ``IndexService`` or ``ShardedIndexService`` (anything
    with ``lookup(queries, backend)`` / ``search(queries, side, backend)`` /
    ``publish()`` and a ``plan``).  Knobs default from ``service.plan``:

    * ``flush_threshold`` -- fuse and dispatch once this many queries are
      queued; default ``plan.flush_threshold`` (the planner sets it to the
      plan's ``large_min`` dispatch crossing), else ``plan.large_min``, else
      :data:`DEFAULT_FLUSH_THRESHOLD`.
    * ``max_wait_us`` -- oldest-request deadline in microseconds; a partial
      batch flushes when it expires.  Default ``plan.max_wait_us`` else
      :data:`DEFAULT_MAX_WAIT_US`.
    * ``queue_depth`` -- bound on queued queries across callers; submits
      block (then raise :class:`PipelineOverloaded`) when it is full.
      Default ``plan.queue_depth`` else ``8 x flush_threshold``.
    * ``publish_interval_s`` -- cadence-thread period.  Default: the plan's
      ``publish_every`` (an insert count) divided by the spec's expected
      ``insert_rate`` (inserts/s), i.e. the time the planner expects that
      many inserts to take; ``None`` when the plan has no cadence (read-only
      plan) -- the cadence thread then only runs if a period is passed
      explicitly.
    * ``cadence`` -- False: no cadence thread, whatever the plan's
      ``publish_every``; the service publishes on its own (a sharded
      plan's auto-publish after ``publish_every`` pending inserts) or the
      caller does.  It takes no ``publish_interval_s`` and no
      ``replanner``, which rides the cadence.
    * ``prewarm`` -- build and run every serving engine (and every
      dispatch tier) before accepting traffic, so the first fused flush does
      not pay the device upload or the kernel library's build.

    Threads start in the constructor; ``close()`` (or the context manager)
    drains queued requests, completes their futures, and joins the threads.
    """

    def __init__(self, service, *, flush_threshold: int | None = None,
                 max_wait_us: float | None = None,
                 queue_depth: int | None = None,
                 publish_interval_s: float | None = None,
                 backend: str | None = None,
                 pad_batches: bool = True,
                 prewarm: bool = True,
                 monitor: Monitor | None = None,
                 replanner: Replanner | None = None,
                 cadence: bool = True):
        plan = getattr(service, "plan", None)
        if not cadence and (publish_interval_s is not None
                            or replanner is not None):
            raise ValueError("cadence=False runs no cadence thread: pass no "
                             "publish_interval_s and no replanner")
        # telemetry defaults to the service's monitor so the pipeline channels
        # (queue depth / flush cause / sojourn) land next to the tier samples
        self.monitor = monitor if monitor is not None \
            else getattr(service, "monitor", None)
        self.replanner = replanner
        if replanner is not None:
            replanner.pipeline = self     # replan swaps reach the flush knobs
            if publish_interval_s is None:
                # the replanner rides the maintenance cadence: make sure the
                # cadence thread exists even for a read-only plan
                publish_interval_s = replanner.interval_s
        if flush_threshold is None:
            flush_threshold = getattr(plan, "flush_threshold", None)
        if flush_threshold is None:
            flush_threshold = getattr(plan, "large_min", None)
        if flush_threshold is None:
            flush_threshold = DEFAULT_FLUSH_THRESHOLD
        if max_wait_us is None:
            max_wait_us = getattr(plan, "max_wait_us", None)
        if max_wait_us is None:
            max_wait_us = DEFAULT_MAX_WAIT_US
        if queue_depth is None:
            queue_depth = getattr(plan, "queue_depth", None)
        if queue_depth is None:
            queue_depth = DEFAULT_QUEUE_DEPTH_FLUSHES * int(flush_threshold)
        if cadence and publish_interval_s is None:
            publish_interval_s = _plan_publish_interval(plan)
        if flush_threshold < 1:
            raise ValueError(f"flush_threshold must be >= 1, got "
                             f"{flush_threshold!r}")
        if max_wait_us <= 0:
            raise ValueError(f"max_wait_us must be > 0, got {max_wait_us!r}")
        if queue_depth < flush_threshold:
            raise ValueError(f"queue_depth ({queue_depth}) must be >= "
                             f"flush_threshold ({flush_threshold}); a queue "
                             "that can never hold a full batch flushes only "
                             "on the deadline")
        if publish_interval_s is not None and publish_interval_s <= 0:
            raise ValueError(f"publish_interval_s must be > 0 (or None for "
                             f"the plan's cadence), got {publish_interval_s!r}")

        self.service = service
        self.flush_threshold = int(flush_threshold)
        self.max_wait_us = float(max_wait_us)
        self.queue_depth = int(queue_depth)
        self.publish_interval_s = publish_interval_s
        self.backend = backend
        self.pad_batches = bool(pad_batches)

        # queue state: per-verb buckets so each flush fuses like with like
        # ("lookup" and each ("search", side) fuse separately -- a fused call
        # must be one service call).  All mutations under _lock; _space wakes
        # blocked submitters, _work wakes the flusher.
        self._lock = make_lock("AsyncIndexService._lock")
        self._space = threading.Condition(self._lock)
        self._work = threading.Condition(self._lock)
        self._buckets: dict[tuple, list[_Request]] = {}
        self._queued = 0                 # total queries across buckets
        self._oldest: float | None = None  # monotonic enqueue time of oldest
        self._closed = False
        self._fatal: BaseException | None = None

        # stats (under _lock)
        self._stats = {"flushes": 0, "threshold_flushes": 0,
                       "deadline_flushes": 0, "drain_flushes": 0,
                       "inline_batches": 0, "coalesced_queries": 0,
                       "max_fused_batch": 0, "publishes": 0,
                       "maintenance_ticks": 0, "compactions": 0}

        if prewarm:
            self.prewarm()

        self._stop_event = threading.Event()
        self._flusher = threading.Thread(target=self._flush_loop,
                                         name="index-pipeline-flush",
                                         daemon=True)
        self._flusher.start()
        self._maintenance = None
        if self.publish_interval_s is not None:
            self._maintenance = threading.Thread(
                target=self._maintenance_loop,
                name="index-pipeline-maintenance", daemon=True)
            self._maintenance.start()

    # ------------------------------------------------------------------ submit
    def lookup_async(self, queries, timeout: float | None = None) -> Future:
        """Queue a point-lookup batch; the Future resolves to the same ranks
        ``service.lookup(queries)`` would return (global ranks, -1 absent)."""
        return self._submit(("lookup",), queries, timeout)

    def search_async(self, queries, side: str = "left",
                     timeout: float | None = None) -> Future:
        """Queue an insertion-rank search (the query plane's primitive);
        resolves to ``service.search(queries, side)``."""
        if side not in ("left", "right"):
            raise ValueError(f"side must be 'left' or 'right', got {side!r}")
        return self._submit(("search", side), queries, timeout)

    def lookup(self, queries, timeout: float | None = None) -> np.ndarray:
        """Sync facade: submit and wait (``lookup_async(...).result()``)."""
        return self.lookup_async(queries, timeout).result(timeout)

    def search(self, queries, side: str = "left",
               timeout: float | None = None) -> np.ndarray:
        """Sync facade over :meth:`search_async`."""
        return self.search_async(queries, side, timeout).result(timeout)

    def _submit(self, kind: tuple, queries, timeout: float | None) -> Future:
        q = np.asarray(queries, np.float64)
        shape = q.shape
        q = np.atleast_1d(q).ravel()
        fut: Future = Future()
        if q.size == 0:
            fut.set_result(np.empty(shape, np.int64))
            return fut
        if q.size >= self.flush_threshold:
            # already a fast-tier batch on its own: run fused inline rather
            # than occupying the whole queue and delaying everyone else
            self._check_open()
            with self._lock:
                self._stats["inline_batches"] += 1
            if self.monitor is not None:
                self.monitor.record(CH_FLUSH, FLUSH_INLINE, int(q.size))
            try:
                fut.set_result(self._run(kind, q).reshape(shape))
            except BaseException as exc:  # surfaced via the future
                fut.set_exception(exc)
            return fut
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            self._raise_if_dead_locked()
            while self._queued + q.size > self.queue_depth:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise PipelineOverloaded(
                            f"request queue full ({self._queued}/"
                            f"{self.queue_depth} queries) for {timeout:g}s; "
                            "the flusher is not keeping up with arrivals -- "
                            "raise queue_depth, lower max_wait_us, or shed "
                            "load")
                self._space.wait(remaining)
                self._raise_if_dead_locked()
            self._buckets.setdefault(kind, []).append(_Request(q, shape, fut))
            self._queued += q.size
            if self._oldest is None:
                self._oldest = time.monotonic()
                self._work.notify()   # arm the flusher's deadline timer
            if self._queued >= self.flush_threshold:
                self._work.notify()
        return fut

    # --------------------------------------------------------------- the flush
    def _run(self, kind: tuple, fused: np.ndarray) -> np.ndarray:
        """One fused service call.  ``pad_batches`` pads the fused batch to
        its power-of-two bucket (repeating the first query; the tail is
        sliced off) so the device backends see a *bounded set of shapes*
        (the reference's jit compiles one program per shape; here it bounds
        the batch sizes, so a flush's tier is one that prewarm ran).  The
        padding changes no answer."""
        n = fused.shape[0]
        if self.pad_batches:
            m = _bucket_size(n)
            if m > n:
                fused = np.concatenate(
                    [fused, np.full(m - n, fused[0], np.float64)])
        if kind[0] == "lookup":
            out = np.asarray(self.service.lookup(fused, self.backend),
                             np.int64)
        else:
            out = np.asarray(self.service.search(fused, kind[1], self.backend),
                             np.int64)
        return out[:n]

    def _take_batches(self) -> list[tuple[tuple, list[_Request]]]:
        """Under _lock: claim everything queued and reset the queue."""
        batches = [(k, reqs) for k, reqs in self._buckets.items() if reqs]
        self._buckets = {}
        self._queued = 0
        self._oldest = None
        if batches:
            self._space.notify_all()
        return batches

    def _flush(self, batches: list[tuple[tuple, list[_Request]]],
               cause: int = FLUSH_DRAIN) -> None:
        """Fuse each verb bucket into one service call; scatter per-caller
        slices back through the futures.  An exception fails exactly the
        futures of the batch that raised it.  ``cause`` is the flush-trigger
        code (:data:`FLUSH_THRESHOLD`/`FLUSH_DEADLINE`/`FLUSH_DRAIN`)
        recorded per fused bucket on the monitor, alongside each resolved
        request's sojourn (enqueue -> result) -- both off the caller path."""
        mon = self.monitor
        for kind, reqs in batches:
            fused = (reqs[0].queries if len(reqs) == 1
                     else np.concatenate([r.queries for r in reqs]))
            with self._lock:
                self._stats["flushes"] += 1
                self._stats["coalesced_queries"] += int(fused.size)
                self._stats["max_fused_batch"] = max(
                    self._stats["max_fused_batch"], int(fused.size))
            if mon is not None:
                mon.record(CH_FLUSH, cause, int(fused.size))
            try:
                out = self._run(kind, fused)
            except BaseException as exc:
                for r in reqs:
                    r.future.set_exception(exc)
                continue
            off = 0
            for r in reqs:
                n = r.queries.size
                r.future.set_result(out[off:off + n].reshape(r.shape))
                off += n
            if mon is not None:
                now = time.perf_counter_ns()
                for r in reqs:
                    mon.record(CH_SOJOURN, now - r.t_enq)

    def _flush_loop(self) -> None:
        try:
            while True:
                with self._lock:
                    cause = FLUSH_DRAIN
                    while True:
                        if self._closed:
                            break
                        now = time.monotonic()
                        if self._queued >= self.flush_threshold:
                            self._stats["threshold_flushes"] += 1
                            cause = FLUSH_THRESHOLD
                            break
                        if self._oldest is not None:
                            expires = self._oldest + self.max_wait_us * 1e-6
                            if now >= expires:
                                self._stats["deadline_flushes"] += 1
                                cause = FLUSH_DEADLINE
                                break
                            self._work.wait(expires - now)
                        else:
                            self._work.wait()
                    if self._closed:
                        return          # close() drains under its own lock
                    if self.monitor is not None:
                        self.monitor.record(CH_QUEUE_DEPTH, self._queued)
                    batches = self._take_batches()
                self._flush(batches, cause)
        except BaseException as exc:     # pragma: no cover - defensive
            self._record_fatal(exc)

    # ------------------------------------------------------------- maintenance
    def _maintenance_loop(self) -> None:
        """Periodic publish (no-op when clean) + the service's auto_rebalance
        check, off the request path.  A crash is fatal to the pipeline and
        re-raised to subsequent submitters and close()."""
        assert self.publish_interval_s is not None
        stop = self._stop_event
        last_epoch = getattr(self.service, "epoch", None)
        try:
            while not stop.wait(self.publish_interval_s):
                result = self.service.publish()
                compacted = 0
                if isinstance(result, dict):     # sharded: {sid: Snapshot};
                    did_publish = bool(result)   # lsm: maintenance summary
                    compacted = result.get("compacted", 0) \
                        if result else 0         # cadence-driven merges
                else:                            # IndexService: a Snapshot,
                    did_publish = result.epoch != last_epoch  # same on no-op
                    last_epoch = result.epoch
                with self._lock:
                    self._stats["maintenance_ticks"] += 1
                    if did_publish:
                        self._stats["publishes"] += 1
                    if compacted:
                        self._stats["compactions"] += compacted
                if self.replanner is not None:
                    # measured telemetry -> re-fit -> (maybe) hot-swap, all on
                    # this thread; rate-limited by the replanner's interval
                    self.replanner.step()
        except BaseException as exc:
            self._record_fatal(exc)

    def _record_fatal(self, exc: BaseException) -> None:
        with self._lock:
            if self._fatal is None:
                self._fatal = exc
            self._closed = True
            batches = self._take_batches()
            self._space.notify_all()
            self._work.notify_all()
        for _, reqs in batches:
            for r in reqs:
                r.future.set_exception(exc)

    # --------------------------------------------------------------- lifecycle
    def prewarm(self, backend: str | None = None) -> None:
        """Build and run the serving engines before taking traffic (see
        ``ShardedIndexService.prewarm`` / ``DispatchEngine.prewarm``).

        First at the threshold's batch bucket -- the exact size a threshold
        flush dispatches -- then once at each engine's own default sizes,
        which for ``dispatch`` is one batch per tier.  Every tier a deadline
        flush or an inline batch can reach has then placed its table on the
        device and, on the card, loaded the kernel library (its first-use
        ``nvcc`` build), so no caller's future waits on either."""
        backend = backend or self.backend
        sizes = (_bucket_size(self.flush_threshold),) if self.pad_batches \
            else (self.flush_threshold,)
        self.service.prewarm(backend, batch_sizes=sizes)
        self.service.prewarm(backend)

    def publish(self):
        """Manual publish passthrough (the cadence thread's tick, on demand)."""
        return self.service.publish()

    # ---------------------------------------------------------- reconfiguring
    def apply_knobs(self, *, flush_threshold: int | None = None,
                    max_wait_us: float | None = None,
                    queue_depth: int | None = None) -> None:
        """Hot-swap the coalescing knobs (None keeps the current value).
        Validated together under the queue lock -- the same invariants as
        construction -- then both conditions wake: blocked submitters re-check
        the new depth, the flusher re-arms against the new threshold and
        deadline.  In-flight futures are untouched."""
        with self._lock:
            ft = (self.flush_threshold if flush_threshold is None
                  else int(flush_threshold))
            mw = self.max_wait_us if max_wait_us is None else float(max_wait_us)
            qd = self.queue_depth if queue_depth is None else int(queue_depth)
            if ft < 1:
                raise ValueError(f"flush_threshold must be >= 1, got {ft!r}")
            if mw <= 0:
                raise ValueError(f"max_wait_us must be > 0, got {mw!r}")
            if qd < ft:
                raise ValueError(f"queue_depth ({qd}) must be >= "
                                 f"flush_threshold ({ft})")
            self.flush_threshold, self.max_wait_us, self.queue_depth = \
                ft, mw, qd
            self._work.notify_all()
            self._space.notify_all()

    def apply_plan(self, plan: "IndexPlan", *, prewarm: bool = False) -> None:
        """Adopt a (re)planned configuration's pipeline knobs -- the
        ``Replanner`` swap path.  Missing plan knobs keep their current
        values; a plan that moves the threshold without pinning a depth gets
        ``DEFAULT_QUEUE_DEPTH_FLUSHES``x headroom (never shrinking the
        current depth below the new threshold's requirement).  The publish
        cadence re-resolves when the maintenance thread is running.  Pass
        ``prewarm=True`` to run the new threshold's batch bucket before
        the next flush."""
        ft = plan.flush_threshold
        if ft is None:
            ft = plan.large_min
        qd = plan.queue_depth
        if qd is None and ft is not None:
            qd = max(self.queue_depth,
                     DEFAULT_QUEUE_DEPTH_FLUSHES * int(ft))
        self.apply_knobs(flush_threshold=ft, max_wait_us=plan.max_wait_us,
                         queue_depth=qd)
        if self._maintenance is not None:
            interval = _plan_publish_interval(plan)
            if interval is not None:
                self.publish_interval_s = interval  # read every cadence tick
        if prewarm:
            self.prewarm()

    @property
    def closed(self) -> bool:
        return self._closed

    def _check_open(self) -> None:
        with self._lock:
            self._raise_if_dead_locked()

    def _raise_if_dead_locked(self) -> None:
        if self._fatal is not None:
            raise PipelineClosed("pipeline maintenance died; see the "
                                 "cause") from self._fatal
        if self._closed:
            raise PipelineClosed("pipeline is closed")

    def pipeline_stats(self) -> dict:
        """Deprecated: use :meth:`metrics`\\ ``().pipeline``.  The legacy
        counter dict (flushes by trigger, fused batch sizes, knobs)."""
        warnings.warn("AsyncIndexService.pipeline_stats() is deprecated; "
                      "use metrics().pipeline", DeprecationWarning,
                      stacklevel=2)
        return dataclasses.asdict(self._pipeline_metrics())

    def _pipeline_metrics(self) -> PipelineMetrics:
        with self._lock:
            stats = dict(self._stats)
            queued = self._queued
        rp = self.replanner
        return PipelineMetrics(
            **stats, queued=queued, flush_threshold=self.flush_threshold,
            max_wait_us=self.max_wait_us, queue_depth=self.queue_depth,
            replans=0 if rp is None else rp.replans)

    def close(self, timeout: float = 10.0) -> None:
        """Drain queued requests (their futures complete), stop both threads,
        and re-raise the first maintenance/flush crash if one happened.
        Idempotent; safe to call from ``with``-exit after an error."""
        with self._lock:
            already = self._closed
            self._closed = True
            batches = self._take_batches()
            self._work.notify_all()
            self._space.notify_all()
            if batches:
                self._stats["drain_flushes"] += 1
        if batches:
            self._flush(batches)
        self._stop_event.set()
        if not already:
            self._flusher.join(timeout)
            if self._maintenance is not None:
                self._maintenance.join(timeout)
        if self._fatal is not None:
            raise PipelineClosed("pipeline maintenance died; see the "
                                 "cause") from self._fatal

    def __enter__(self) -> "AsyncIndexService":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # don't mask an in-flight exception with the close-time re-raise
        try:
            self.close()
        except PipelineClosed:
            if exc_type is None:
                raise

    # ----------------------------------------------------------- observability
    def metrics(self) -> ServiceMetrics:
        """The wrapped service's typed snapshot with the pipeline's counters
        and knobs attached as :class:`PipelineMetrics` -- the one
        observability surface for the whole serving stack."""
        return dataclasses.replace(self.service.metrics(),
                                   pipeline=self._pipeline_metrics())

    def service_stats(self) -> dict:
        """Deprecated: use :meth:`metrics`.  The wrapped service's legacy
        dict plus the pipeline counters, derived from the typed snapshot."""
        warnings.warn("AsyncIndexService.service_stats() is deprecated; "
                      "use metrics()", DeprecationWarning, stacklevel=2)
        m = self.metrics()
        return {"version": m.shard_set_version,
                "n_shards": m.n_shards,
                "imbalance": m.imbalance,
                "rebalances": m.rebalances,
                "rebalance_skipped": m.rebalance_skipped,
                "last_rebalance": m.last_rebalance,
                "pending_inserts": m.pending_inserts,
                "query_counts": m.query_counts,
                "pipeline": dataclasses.asdict(m.pipeline)}


def _bucket_size(n: int) -> int:
    """The power-of-two batch bucket ``n`` pads into (floor 16, so tiny
    deadline flushes share a handful of shapes instead of one each)."""
    return max(16, 1 << (int(n) - 1).bit_length())


def _plan_publish_interval(plan) -> float | None:
    """Resolve a plan's count-based publish cadence into a time period using
    the spec's expected insert rate: publish_every inserts at insert_rate
    inserts/s take publish_every/insert_rate seconds.  None when the plan has
    no cadence or no rate to resolve it against."""
    if plan is None or getattr(plan, "publish_every", None) is None:
        return None
    spec = getattr(plan, "spec", None)
    rate = getattr(spec, "insert_rate", 0.0) if spec is not None else 0.0
    if rate and rate > 0:
        return max(plan.publish_every / rate, 1e-3)
    return 1.0     # cadence requested but no rate hint: 1s ticks are cheap


def open_pipeline(keys, spec_or_plan: "FitSpec | IndexPlan", *,
                  payload: np.ndarray | None = None,
                  flush_threshold: int | None = None,
                  max_wait_us: float | None = None,
                  queue_depth: int | None = None,
                  publish_interval_s: float | None = None,
                  prewarm: bool = True,
                  replan_interval_s: float | None = None,
                  **service_kwargs) -> AsyncIndexService:
    """SLO-driven construction of the whole serving pipeline: resolve the
    spec (``fit.plan``), build the service (``fit.open_index``), and wrap it
    in the coalescing front door with the plan's pipeline knobs.  Extra
    ``service_kwargs`` pass through to the service constructor (notably
    ``monitor=Monitor()`` to turn telemetry on).  ``replan_interval_s``
    additionally attaches a :class:`repro_torch.index.telemetry.Replanner`
    on the maintenance cadence (requires a monitor), closing the measure ->
    re-fit -> re-plan loop."""
    from .fit import open_index
    svc = open_index(keys, spec_or_plan, payload=payload, **service_kwargs)
    replanner = None
    if replan_interval_s is not None:
        replanner = Replanner(svc, interval_s=replan_interval_s)
    return AsyncIndexService(svc, flush_threshold=flush_threshold,
                             max_wait_us=max_wait_us, queue_depth=queue_depth,
                             publish_interval_s=publish_interval_s,
                             prewarm=prewarm, replanner=replanner)
