"""The port's telemetry plane (``repro_torch.index.telemetry``) against the
JAX package's, on the inputs of ``tests/test_replan.py``.

The module is host code: the Monitor's ring semantics and JSONL backend,
``tier_metrics`` and the metrics tree's JSON must behave as the reference's,
and a ``Replanner`` fed the same measurements over the same service proposes
and applies the same plan (the port's device profile given the reference
profile's numbers, as test input), to tolerance 0.
"""
import dataclasses
import json
import threading

import numpy as np
import pytest

from repro.core.cost_model import TPUCostParams
from repro.index import fit as ref_fit
from repro.index import telemetry as ref_tel
from repro.index.sharded import ShardedIndexService as RefSharded
from repro_torch.core.cost_model import GPUCostParams
from repro_torch.index import fit, telemetry as tel
from repro_torch.index.sharded import ShardedIndexService
from repro_torch.serve import IndexService

CPU = {"device": "cpu"}
ON_CPU = {"cuda": CPU, "torch-bisect": CPU, "dispatch": CPU}


def _gpu(tpu):
    return GPUCostParams(hbm_gbps=tpu.hbm_gbps, setup_ns=tpu.dma_setup_ns,
                         step_ns=tpu.vmem_step_ns,
                         bytes_per_key=tpu.bytes_per_key,
                         launch_ns=tpu.launch_ns, plan_ns=tpu.plan_ns)


def test_ring_keeps_the_last_rows_in_order_like_the_reference():
    ours, ref = (tel.Monitor(tel.MemoryBackend(capacity=4)),
                 ref_tel.Monitor(ref_tel.MemoryBackend(capacity=4)))
    for mon in (ours, ref):
        for i in range(10):
            mon.record("ch", i, i * 10)
        mon.record_many("keys", [1.0, 2.0])
        mon.record_many("keys", np.array([3.0]))
    np.testing.assert_array_equal(ours.channel("ch"), ref.channel("ch"))
    np.testing.assert_array_equal(ours.channel("ch")[:, 0], [6, 7, 8, 9])
    np.testing.assert_array_equal(ours.channel("keys"), [1.0, 2.0, 3.0])
    assert ours.count("ch") == ref.count("ch") == 10
    assert ours.channels() == ref.channels()
    assert ours.channel("none").shape == (0, 0)
    ours.clear("ch")
    assert ours.channels() == ["keys"]
    ours.enabled = False
    ours.record("ch", 1.0)
    assert ours.channels() == ["keys"]
    with pytest.raises(ValueError, match="capacity"):
        tel.MemoryBackend(capacity=0)
    with pytest.raises(ValueError, match="capacity"):
        tel.Monitor(tel.MemoryBackend(), capacity=8)


def test_jsonl_backend_round_trip(tmp_path):
    ours = tmp_path / "ours.jsonl"
    ref = tmp_path / "ref.jsonl"
    for mon in (tel.Monitor(tel.JSONLBackend(ours, capacity=2)),
                ref_tel.Monitor(ref_tel.JSONLBackend(ref, capacity=2))):
        mon.record("a", 1, 2)
        mon.record_many("k", [5.0, 6.0])
        assert mon.flush() == 2
        assert mon.flush() == 0
        for i in range(5):
            mon.record("a", i, i)          # 3 of them fall off the ring
        mon.close()
        assert mon.backend.dropped == 3
    assert ours.read_text() == ref.read_text()
    rows = [json.loads(x) for x in ours.read_text().splitlines()]
    assert [(r["ch"], r["i"]) for r in rows] == [
        ("a", 0), ("k", 0), ("a", 4), ("a", 5)]


def test_concurrent_recording_loses_no_row():
    mon = tel.Monitor(tel.MemoryBackend(capacity=1 << 14))
    n, threads = 2000, 4

    def hammer(t):
        for i in range(n):
            mon.record("ch", t, i)

    ts = [threading.Thread(target=hammer, args=(t,)) for t in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in ts)
    assert mon.channel("ch").shape == (n * threads, 2)
    assert mon.count("ch") == n * threads


def _synthetic(rng, fixed, per, sizes, reps=12, noise=0.03):
    return [(b, (fixed + per * b) * (1 + rng.normal(0, noise)))
            for b in sizes for _ in range(reps)]


def _feed(mons, rng):
    """tests/test_replan.py's measurements: the medium tier far cheaper
    than modeled, so the first re-plan has a real win."""
    truth = {"small": (100.0, 500.0), "medium": (5_000.0, 10.0),
             "large": (500_000.0, 9.0)}
    sizes = {"small": [1, 8, 32], "medium": [128, 1024, 4096],
             "large": [8192, 32768]}
    for tier, (fixed, per) in truth.items():
        for b, ns in _synthetic(rng, fixed, per, sizes[tier]):
            for mon in mons:
                mon.record(tel.CH_TIER_PREFIX + tier, b, ns)


def test_tier_metrics_equal_the_reference():
    ours, ref = tel.Monitor(), ref_tel.Monitor()
    _feed((ours, ref), np.random.default_rng(3))
    ours.record(tel.CH_TIER_PREFIX + "large", 5.0, 7.0)
    ref.record(ref_tel.CH_TIER_PREFIX + "large", 5.0, 7.0)
    got, want = tel.tier_metrics(ours), ref_tel.tier_metrics(ref)
    assert [dataclasses.asdict(t) for t in got] == \
        [dataclasses.asdict(t) for t in want]
    assert tel.tier_metrics(None) == ()
    assert set(ours.tier_samples()) == {"small", "medium", "large"}


def _services():
    keys = np.sort(np.random.default_rng(0).uniform(0, 1e6, 30_000))
    tpu = TPUCostParams()
    plan = fit.plan(keys, fit.FitSpec(error=64, gpu_params=_gpu(tpu)),
                    assume_sorted=True).replace(n_shards=2,
                                                backend="dispatch")
    ref_plan = ref_fit.plan(keys, ref_fit.FitSpec(error=64, tpu_params=tpu),
                            assume_sorted=True).replace(n_shards=2,
                                                        backend="dispatch")
    ours = ShardedIndexService(keys, plan=plan, monitor=tel.Monitor(),
                               engine_opts=ON_CPU, assume_sorted=True)
    ref = RefSharded(keys, plan=ref_plan, monitor=ref_tel.Monitor(),
                     assume_sorted=True)
    for svc in (ours, ref):
        svc.lookup(np.linspace(0, 1e6, 64), "numpy")
        svc.lookup(np.linspace(0, 1e6, 64), "numpy")
    return ours, ref


def test_replanner_swaps_like_the_reference_then_holds():
    ours, ref = _services()
    rng = np.random.default_rng(11)
    _feed((ours.monitor, ref.monitor), rng)
    rp = tel.Replanner(ours, interval_s=0.01, hysteresis=0.05)
    ref_rp = ref_tel.Replanner(ref, interval_s=0.01, hysteresis=0.05)
    assert rp.measured_curves() == ref_rp.measured_curves()
    np.testing.assert_array_equal(rp.served_keys(), ref_rp.served_keys())
    served, ref_served = rp.replan(), ref_rp.replan()
    assert served is not None and ref_served is not None
    assert rp.last_win == ref_rp.last_win
    fields = ("error", "n_shards", "buffer_size", "small_max", "large_min",
              "publish_every", "flush_threshold", "max_wait_us",
              "queue_depth", "objective", "budget", "hardware", "n_keys",
              "revision")
    assert [getattr(served, f) for f in fields] == \
        [getattr(ref_served, f) for f in fields]
    assert [dataclasses.asdict(c) for c in served.candidates] == \
        [dataclasses.asdict(c) for c in ref_served.candidates]
    assert served.backend == ref_served.backend == "dispatch"
    eng = ours.handles[0].engine("dispatch")
    assert (eng.small_max, eng.large_min) == (served.small_max,
                                              served.large_min)
    for _ in range(3):
        _feed((ours.monitor, ref.monitor), rng)
        assert rp.replan() is None and ref_rp.replan() is None
        assert rp.last_win == ref_rp.last_win
    assert (rp.checks, rp.replans) == (ref_rp.checks, ref_rp.replans) == \
        (4, 1)
    np.testing.assert_array_equal(ours.monitor.channel(tel.CH_REPLAN),
                                  ref.monitor.channel(ref_tel.CH_REPLAN))


def test_replanner_needs_a_monitor_and_rate_limits():
    keys = np.arange(1000, dtype=np.float64)
    svc = ShardedIndexService(keys, error=16, engine_opts=ON_CPU,
                              assume_sorted=True)
    with pytest.raises(ValueError, match="Monitor"):
        tel.Replanner(svc)
    mon_svc = IndexService(keys, error=16, backend="dispatch",
                           monitor=tel.Monitor(), engine_opts=ON_CPU,
                           assume_sorted=True)
    rp = tel.Replanner(mon_svc, interval_s=3600.0)
    assert rp.step(now=0.0) is None          # nothing measured yet
    before = rp.checks
    rp.step(now=1.0)                         # inside the interval: skipped
    assert rp.checks == before


def test_dispatch_records_tier_samples_and_metrics_round_trip():
    """The port's DispatchEngine records (batch, wall ns) on tier.<tier>;
    the metrics tree round-trips through JSON, and the reference's JSON of
    the same tree loads into the port's."""
    keys = np.sort(np.random.default_rng(0).uniform(0, 1e6, 8000))
    mon = tel.Monitor()
    svc = ShardedIndexService(keys, error=64, n_shards=2, buffer_size=16,
                              backend="dispatch", monitor=mon,
                              engine_opts={**ON_CPU, "dispatch": {
                                  **CPU, "small_max": 8, "large_min": 64}},
                              assume_sorted=True)
    q = keys[::17][:256]
    for size in (1, 8, 32, 256):
        for _ in range(3):
            svc.lookup(q[:size])
    svc.range(float(keys[10]), float(keys[500]))
    m = svc.metrics()
    assert m.query_counts["points"] == 3 * (1 + 8 + 32 + 256)
    assert m.query_counts["ranges"] == 1
    assert {t.tier for t in m.tiers} == {"small", "medium", "large"}
    assert mon.count(tel.CH_SERVED_KEYS) >= 1
    assert tel.ServiceMetrics.from_json(m.to_json()) == m
    doc = json.loads(m.to_json())
    doc["schema_version"] = 99
    with pytest.raises(ValueError, match="schema_version"):
        tel.ServiceMetrics.from_json(json.dumps(doc))
    ref = RefSharded(keys, error=64, n_shards=2, buffer_size=16,
                     backend="numpy", assume_sorted=True)
    ref_m = ref.metrics()
    assert dataclasses.asdict(tel.ServiceMetrics.from_json(
        ref_m.to_json())) == dataclasses.asdict(ref_m)
