"""The port's async front door (``repro_torch.index.pipeline``) against the
JAX package's (``repro.index.pipeline``).

Concurrent callers through ``AsyncIndexService`` get answers equal bit for
bit to the same calls made single-threaded on the bare service, on every
port backend (numpy, torch-window, torch-bisect, cuda -- its plain twin on
the CPU -- and dispatch) and over the LSM service; ``_bucket_size`` and
``open_pipeline``'s resolved knobs equal the reference's.  Each behaviour
is driven: inline bypass, deadline flush, backpressure, drain on close,
rejection after close, a maintenance crash, prewarm of every tier, and
the cadence compacting an LSM plan -- with the lock-order watchdog on.
The fused kernel's launch counter stays exact under many threads.

Every join, wait and ``Future.result`` carries a timeout; timing margins
are seconds, not the microsecond knobs under test.
"""
import sys
import threading
import time

import numpy as np
import pytest

from repro.core.cost_model import TPUCostParams
from repro.index import fit as ref_fit
from repro.index import pipeline as ref_pipeline
from repro_torch.analysis import sanitizer
from repro_torch.core.cost_model import GPUCostParams
from repro_torch.index import LsmIndexService, available_backends, fit
from repro_torch.index.pipeline import _bucket_size, _plan_publish_interval
from repro_torch.kernels import fitting_lookup as fl
from repro_torch.serve import (AsyncIndexService, IndexService,
                               PipelineClosed, PipelineOverloaded,
                               open_pipeline)

CPU = {"device": "cpu"}
ON_CPU = {"cuda": CPU, "torch-bisect": CPU, "torch-window": CPU,
          "dispatch": {**CPU, "small_max": 4, "large_min": 24}}
T = 30.0                                     # every wait's timeout, seconds


def _keys(n=512, seed=0):
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(n * 8, size=n, replace=False)).astype(np.float64)


def _service(keys, backend="cuda", **kw):
    return IndexService(keys, error=16, backend=backend, engine_opts=ON_CPU,
                        assume_sorted=True, **kw)


def _hammer(pipe, direct, keys, n_threads=6, per_thread=12, seed=100):
    """Mixed lookup / search traffic from ``n_threads`` callers through the
    pipe, each answer held to the same call made on ``direct``."""
    barrier = threading.Barrier(n_threads)
    failures: list = []

    def caller(tid):
        rng = np.random.default_rng(seed + tid)
        try:
            barrier.wait(T)
            for _ in range(per_thread):
                size = int(rng.integers(1, 6))
                hits = keys[rng.integers(0, keys.size, size)]
                misses = np.floor(rng.uniform(keys[0] - 3, keys[-1] + 3, size))
                q = np.where(rng.random(size) < 0.7, hits, misses)
                verb = int(rng.integers(0, 3))
                if verb == 0:
                    got, want = pipe.lookup(q, T), direct.lookup(q)
                else:
                    side = "left" if verb == 1 else "right"
                    got = pipe.search(q, side, T)
                    want = direct.search(q, side)
                if not np.array_equal(got, want):
                    failures.append((tid, q, got, want))
        except BaseException as exc:  # pragma: no cover - surfaced below
            failures.append((tid, exc))

    threads = [threading.Thread(target=caller, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(4 * T)
    assert not any(t.is_alive() for t in threads)
    return failures


@pytest.mark.parametrize("backend", available_backends())
def test_concurrent_callers_equal_the_bare_service(backend):
    keys = _keys()
    svc = _service(keys, backend)
    with AsyncIndexService(svc, flush_threshold=16, max_wait_us=2_000.0,
                           queue_depth=32, prewarm=False) as pipe:
        failures = _hammer(pipe, svc, keys)
        m = pipe.metrics().pipeline
    assert not failures, failures[:3]
    assert m.coalesced_queries > 0 and m.flushes >= 1


def test_concurrent_callers_over_the_lsm_service():
    keys = np.sort(np.random.default_rng(1).integers(0, 3000, 2000)
                   ).astype(np.float64)
    svc = LsmIndexService(keys, error=16, memtable_capacity=64,
                          level_fanout=4, engine_opts=ON_CPU,
                          assume_sorted=True)
    svc.insert_many(np.arange(0.0, 3000.0, 7.0))
    svc.delete(21.0)
    with AsyncIndexService(svc, flush_threshold=16, max_wait_us=2_000.0,
                           queue_depth=64, prewarm=True) as pipe:
        failures = _hammer(pipe, svc, np.sort(np.concatenate(
            [keys, np.arange(0.0, 3000.0, 7.0)])))
    assert not failures, failures[:3]


def test_bucket_size_equals_the_reference():
    ns = range(1, 2 ** 20 + 1)
    assert [_bucket_size(n) for n in ns] == \
        [ref_pipeline._bucket_size(n) for n in ns]


@pytest.mark.parametrize("kind", ["inplace", "lsm"])
def test_open_pipeline_resolves_the_references_knobs(kind):
    """The same FitSpec gives the same flush threshold, deadline, queue
    depth and publish interval in both packages.  The dispatch crossings
    come from the device profile, so the port's is given the reference TPU
    profile's numbers (as test input, as ``tests/test_torch_fit.py`` does).
    """
    keys = _keys(4096, seed=2)
    kw = {"error": 32, "insert_rate": 2000.0, "batch_sizes": (1, 64, 4096)}
    if kind == "lsm":
        kw["write_heavy"] = True
    tpu = TPUCostParams()
    gpu = GPUCostParams(hbm_gbps=tpu.hbm_gbps, setup_ns=tpu.dma_setup_ns,
                        step_ns=tpu.vmem_step_ns,
                        bytes_per_key=tpu.bytes_per_key,
                        launch_ns=tpu.launch_ns, plan_ns=tpu.plan_ns)
    with open_pipeline(keys, fit.FitSpec(**kw, gpu_params=gpu),
                       prewarm=False, engine_opts=ON_CPU) as ours:
        ref = ref_pipeline.open_pipeline(keys, ref_fit.FitSpec(**kw),
                                         prewarm=False)
        try:
            got = (ours.flush_threshold, ours.max_wait_us, ours.queue_depth,
                   ours.publish_interval_s)
            want = (ref.flush_threshold, ref.max_wait_us, ref.queue_depth,
                    ref.publish_interval_s)
            assert got == want
            assert got[3] == _plan_publish_interval(ours.service.plan) > 0
            assert type(ours.service).__name__ == type(ref.service).__name__
            np.testing.assert_array_equal(ours.lookup(keys[:40], T),
                                          ref.lookup(keys[:40], T))
        finally:
            ref.close()


def test_inline_bypass_at_the_threshold():
    keys = _keys()
    svc = _service(keys)
    with AsyncIndexService(svc, flush_threshold=8, max_wait_us=1e6,
                           prewarm=False) as pipe:
        fut = pipe.lookup_async(keys[:8])             # == threshold: inline
        assert fut.done()
        np.testing.assert_array_equal(fut.result(0), svc.lookup(keys[:8]))
        futs = [pipe.lookup_async(keys[i:i + 1]) for i in range(8)]
        for i, f in enumerate(futs):
            np.testing.assert_array_equal(f.result(T),
                                          svc.lookup(keys[i:i + 1]))
        m = pipe.metrics().pipeline
    assert m.inline_batches == 1 and m.threshold_flushes >= 1


def test_deadline_flush_with_a_partial_batch():
    keys = _keys()
    svc = _service(keys)
    with AsyncIndexService(svc, flush_threshold=10_000, max_wait_us=50_000.0,
                           prewarm=False) as pipe:
        got = pipe.search(keys[:3], "right", timeout=T)
        m = pipe.metrics().pipeline
    np.testing.assert_array_equal(got, svc.search(keys[:3], "right"))
    assert m.deadline_flushes >= 1 and m.threshold_flushes == 0


def test_full_queue_raises_overloaded_then_close_drains():
    keys = _keys()
    svc = _service(keys)
    pipe = AsyncIndexService(svc, flush_threshold=128, queue_depth=128,
                             max_wait_us=10_000_000.0, prewarm=False)
    try:
        futs = [pipe.lookup_async(keys[4 * i:4 * i + 4]) for i in range(25)]
        with pytest.raises(PipelineOverloaded):
            pipe.lookup_async(keys[:32], timeout=0.2)   # 100 + 32 > 128
    finally:
        pipe.close()
    for i, f in enumerate(futs):
        np.testing.assert_array_equal(f.result(0),
                                      svc.lookup(keys[4 * i:4 * i + 4]))
    assert pipe.metrics().pipeline.drain_flushes >= 1


def test_closed_pipeline_rejects_new_work():
    keys = _keys()
    pipe = AsyncIndexService(_service(keys), flush_threshold=10_000,
                             max_wait_us=5_000_000.0, prewarm=False)
    futs = [pipe.search_async(keys[i:i + 2]) for i in range(6)]
    pipe.close()
    for i, f in enumerate(futs):
        np.testing.assert_array_equal(f.result(0), [i, i + 1])
    assert pipe.closed
    with pytest.raises(PipelineClosed, match="closed"):
        pipe.lookup_async(keys[:1])
    pipe.close()                                      # idempotent


def test_maintenance_crash_is_surfaced_to_submitters(monkeypatch):
    svc = _service(_keys())

    def boom():
        raise RuntimeError("publish exploded")

    monkeypatch.setattr(svc, "publish", boom)
    pipe = AsyncIndexService(svc, publish_interval_s=0.02, prewarm=False)
    deadline = time.monotonic() + T
    while time.monotonic() < deadline and not pipe.closed:
        time.sleep(0.01)
    assert pipe.closed
    with pytest.raises(PipelineClosed) as exc:
        pipe.lookup_async(np.array([1.0]))
    assert isinstance(exc.value.__cause__, RuntimeError)
    with pytest.raises(PipelineClosed):
        pipe.close()


def test_prewarm_runs_every_tier_before_traffic():
    """Prewarm builds the threshold bucket's tier and then every dispatch
    tier, so no flush (deadline, threshold or inline) builds an engine or,
    on the card, the kernel library."""
    keys = _keys(2048)
    svc = IndexService(keys, error=16, backend="dispatch",
                       engine_opts={"dispatch": {**CPU, "small_max": 4,
                                                 "large_min": 300},
                                    "torch-bisect": CPU, "cuda": CPU},
                       assume_sorted=True)
    eng = svc.handle.engine("dispatch")
    assert not eng._engines
    with AsyncIndexService(svc, flush_threshold=300, prewarm=True) as pipe:
        assert set(eng._engines) == {"numpy", "torch-bisect", "cuda"}
        built = dict(eng._engines)
        np.testing.assert_array_equal(pipe.lookup(keys[:400], T),
                                      np.arange(400))
        assert eng._engines == built


def test_cadence_drives_lsm_compaction_under_a_write_heavy_spec():
    """``open_pipeline`` on a write-heavy spec serves from the LSM; the
    maintenance cadence spills and compacts while callers read, every
    answer exact, with the lock-order watchdog on."""
    keys = _keys(2048, seed=3)
    prev = sanitizer.set_enabled(True)
    try:
        pipe = open_pipeline(keys, fit.FitSpec(error=32, write_heavy=True,
                                               insert_rate=4096.0),
                             publish_interval_s=0.01, engine_opts=ON_CPU,
                             prewarm=False)
        with pipe:
            svc = pipe.service
            assert isinstance(svc, LsmIndexService)
            cap = svc.memtable_capacity
            new = np.arange(1.0, 8 * cap, 2.0)[:5 * cap]   # 5 spills' worth
            svc.insert_many(new)
            live = np.sort(np.concatenate([keys, new]))
            deadline = time.monotonic() + T
            while time.monotonic() < deadline and \
                    svc.metrics().lsm.compactions < 1:
                q = live[::37]
                np.testing.assert_array_equal(pipe.lookup(q, T),
                                              np.searchsorted(live, q))
            m = pipe.metrics()
        assert m.lsm.compactions >= 1 and m.pipeline.compactions >= 1
        assert m.lsm.live_keys == live.size
    finally:
        sanitizer.set_enabled(prev)


def test_no_cadence_leaves_publishing_to_an_inplace_plans_count():
    """``cadence=False`` over an in-place plan that has a ``publish_every``
    starts no cadence thread: the service publishes at the count alone, so
    inserts short of it stay unseen however long the pipe runs; with a
    period or a replanner it is refused."""
    keys = _keys(4096, seed=4)
    svc = fit.open_index(keys, fit.FitSpec(error=32, insert_rate=64.0),
                         assume_sorted=True, engine_opts=ON_CPU)
    pe = svc.plan.publish_every
    assert svc.plan.write_mode == "inplace" and pe == 64
    assert _plan_publish_interval(svc.plan) == 1.0
    with pytest.raises(ValueError, match="cadence=False"):
        AsyncIndexService(svc, publish_interval_s=0.01, cadence=False,
                          prewarm=False)
    with AsyncIndexService(svc, cadence=False, prewarm=False) as pipe:
        assert pipe._maintenance is None and pipe.publish_interval_s is None
        new = np.arange(1.0, 4 * pe, 2.0)[:pe + 5]    # one publish, 5 left
        svc.insert_many(new)
        assert svc.pending_inserts == 5
        time.sleep(1.5)                  # past the plan's 1 s period
        live = np.sort(np.concatenate([keys, new[:pe]]))
        np.testing.assert_array_equal(pipe.search(live[::7], "left", T),
                                      np.searchsorted(live, live[::7]))
        assert svc.pending_inserts == 5


def test_launch_counter_is_exact_under_threads():
    """``_count_launch`` is the counters' one increment: many threads with a
    short switch interval lose no update."""
    def fn():
        pass

    fn.launches = 0
    n_threads, per = 16, 2000
    barrier = threading.Barrier(n_threads)

    def bump():
        barrier.wait(T)
        for _ in range(per):
            fl._count_launch(fn)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=bump) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(T)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert fn.launches == n_threads * per
    fn.launches = 0                                   # resettable
    fl._count_launch(fn)
    assert fn.launches == 1
