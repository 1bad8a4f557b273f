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
import time

import numpy as np
import pytest
import torch

from repro.core.cost_model import TPUCostParams
from repro.index import fit as ref_fit
from repro.index import telemetry as ref_tel
from repro.index.sharded import ShardedIndexService as RefSharded
from repro_torch.core.cost_model import GPUCostParams
from repro_torch.index import fit, telemetry as tel
from repro_torch.index.lsm import LsmIndexService
from repro_torch.index.sharded import ShardedIndexService
from repro_torch.serve import IndexService

CPU = {"device": "cpu"}
ON_CPU = {"cuda": CPU, "torch-bisect": CPU, "dispatch": CPU}
ALL_ON_CPU = {**ON_CPU, "torch-window": CPU}


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


# ------------------------------------------------------------------ spans
def _cpu_profiler():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _count_record_functions(monkeypatch) -> list:
    """Patch the profiler's ``record_function`` to note each range a span
    opens (the span looks it up on the module at every entry)."""
    opened = []
    real = torch.autograd.profiler.record_function

    def counting(name, *args):
        opened.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    return opened


@pytest.mark.parametrize("state", ["none", "disabled"])
def test_a_span_without_an_enabled_monitor_records_and_opens_nothing(
        monkeypatch, state):
    mon = None if state == "none" else tel.Monitor()
    if mon is not None:
        mon.enabled = False
    opened = _count_record_functions(monkeypatch)
    with _cpu_profiler():
        ctx = tel.span(mon, "engine.stage", 3)
        with ctx:
            pass
        if mon is not None:
            assert mon.span("engine.stage") is ctx
            assert mon.channels() == []
    # one shared null context, whatever the name or tags
    assert ctx is tel.span(None, "lsm.fit", 1) is tel._NULL_SPAN
    assert opened == []


def test_an_enabled_span_records_start_duration_and_tags():
    mon = tel.Monitor()
    before = time.time_ns()
    with tel.span(mon, "lsm.fit", 2):
        time.sleep(0.002)
    with mon.span("lsm.fit", 3):
        pass
    after = time.time_ns()
    assert mon.channels() == [tel.CH_SPAN_PREFIX + "lsm.fit"]
    rows = mon.channel("span.lsm.fit")
    assert rows.shape == (2, 3)
    assert np.all((rows[:, 0] >= before - 1e3) & (rows[:, 0] <= after + 1e3))
    assert rows[0, 0] <= rows[1, 0]
    assert rows[0, 1] >= 2e6 and rows[1, 1] < rows[0, 1]
    np.testing.assert_array_equal(rows[:, 2], [2, 3])
    with pytest.raises(KeyError):          # an error inside still records
        with mon.span("lsm.fit", 4):
            raise KeyError("x")
    assert mon.count("span.lsm.fit") == 3


def test_record_function_opens_only_under_a_profiler_and_nests(monkeypatch):
    mon = tel.Monitor()
    opened = _count_record_functions(monkeypatch)
    with mon.span("lsm.read"):
        with mon.span("engine.stage"):
            pass
    assert opened == []
    with _cpu_profiler() as prof:
        with mon.span("lsm.read"):
            with mon.span("engine.stage"):
                torch.ones(4).add_(1)
    assert opened == ["lsm.read", "engine.stage"]
    events = {e.name: e for e in prof.events()}
    outer, inner = events["lsm.read"], events["engine.stage"]
    assert inner.cpu_parent is not None and inner.cpu_parent.name == \
        "lsm.read"
    assert outer.time_range.start <= inner.time_range.start
    assert inner.time_range.end <= outer.time_range.end
    assert mon.count("span.lsm.read") == mon.count("span.engine.stage") == 2


def test_span_rows_sit_on_the_profiler_clock():
    """A row's start is on the unix clock the profiler stamps its host
    events with: each lies within 1 ms of its event's start."""
    mon = tel.Monitor()
    names = ["service.route", "service.scatter", "engine.stage",
             "engine.cast"]
    with _cpu_profiler() as prof:
        for name in names * 3:
            with mon.span(name):
                torch.ones(64).sum()
            time.sleep(0.002)
    t0_ns = prof.profiler.kineto_results.trace_start_ns()
    for name in names:
        starts = sorted(t0_ns + e.time_range.start * 1e3
                        for e in prof.events() if e.name == name)
        rows = mon.channel(tel.CH_SPAN_PREFIX + name)
        assert len(starts) == rows.shape[0] == 3
        np.testing.assert_allclose(rows[:, 0], starts, rtol=0, atol=1e6)


# the construction's publish flushes each tree (tree.flush) and the first
# search builds the view's engine (engine.build); past one shard that
# engine's device form is the view's, assembled (service.view_build)
SERVICE_SPANS = {"service.route", "engine.stage", "engine.cast",
                 "tree.flush", "engine.build"}
ROUTED_SPANS = SERVICE_SPANS | {"service.view_build"}
LSM_SPANS = {"lsm.read", "lsm.merge", "lsm.fit", "lsm.upload",
             "engine.stage", "engine.cast"}


def _spans(mon) -> set:
    return {c[len(tel.CH_SPAN_PREFIX):] for c in mon.channels()
            if c.startswith(tel.CH_SPAN_PREFIX)}


@pytest.mark.parametrize("backend", ["dispatch", "cuda"])
def test_one_shard_search_records_every_span_and_answers_alike(backend):
    keys = np.sort(np.random.default_rng(0).integers(
        0, 2 ** 20, 40_000)).astype(np.float64)
    q = np.concatenate([keys[::7], np.random.default_rng(1).integers(
        -10, 2 ** 20 + 10, 5000).astype(np.float64)])
    answers = []
    for mon in (tel.Monitor(), None):
        svc = IndexService(keys, error=64, backend=backend, monitor=mon,
                           engine_opts=ALL_ON_CPU, assume_sorted=True)
        got = [svc.search(q, "left"), svc.search(q, "right"), svc.lookup(q)]
        answers.append(got)
        if mon is not None:
            # one shard answers unrouted: no view, every route row (both
            # searches and the lookup) tagged with the view's one shard and
            # its one engine call
            assert _spans(mon) == SERVICE_SPANS
            route = mon.channel("span.service.route")
            assert route.shape == (3, 4)
            np.testing.assert_array_equal(route[:, 2], [1, 1, 1])
            np.testing.assert_array_equal(route[:, 3], [1, 1, 1])
            # every engine call stages once and casts once
            assert mon.count("span.engine.stage") == \
                mon.count("span.engine.cast") == 3
            assert not {"service.query_mix", "service.shard_load",
                        "service.skew"} & set(mon.channels())
    for ours, plain in zip(*answers):
        assert ours.dtype == plain.dtype
        np.testing.assert_array_equal(ours, plain)


# each routed verb as two calls (`_routed_oracle` gives their answers)
ROUTED_VERBS = {
    "search": lambda svc, q: [svc.search(q, "left"), svc.search(q, "right")],
    "lookup": lambda svc, q: [svc.lookup(q), svc.lookup(q[::-1])],
    "point": lambda svc, q: [svc.point(q).rank, svc.point(q[::-1]).rank],
}


def _routed_oracle(verb, keys, q):
    if verb == "search":
        return [np.searchsorted(keys, q, side) for side in ("left", "right")]
    out = []
    for x in (q, q[::-1]):
        left = np.searchsorted(keys, x, "left")
        hit = (left < keys.size) & (keys[np.minimum(left, keys.size - 1)]
                                    == x)
        out.append(np.where(hit, left, -1))
    return out


@pytest.mark.parametrize("verb", sorted(ROUTED_VERBS))
@pytest.mark.parametrize("backend", ["dispatch", "cuda"])
def test_routed_search_records_the_scatter_and_tags_the_shard_count(backend,
                                                                    verb):
    """Every routed read verb (``search``, ``lookup``, ``point``) answers a
    view of three shards in one engine call over the view's table: a
    ``service.route`` row tagged with the shard count and 1 a call, no
    scatter, one assembly of the view's device form, and answers equal to
    the unmonitored service's and the oracle's."""
    keys = np.sort(np.random.default_rng(2).integers(
        0, 2 ** 20, 40_000)).astype(np.float64)
    q = np.concatenate([keys[::7], np.random.default_rng(3).integers(
        -10, 2 ** 20 + 10, 5000).astype(np.float64)])
    answers = []
    for mon in (tel.Monitor(), None):
        # dispatch's tiers pinned so that every shard's batch reaches the
        # device tier, whose engine records the stage and cast spans
        svc = ShardedIndexService(
            keys, error=64, n_shards=3, backend=backend, monitor=mon,
            engine_opts={**ALL_ON_CPU, "dispatch": {
                **CPU, "small_max": 4, "large_min": 300}},
            assume_sorted=True)
        answers.append(ROUTED_VERBS[verb](svc, q))
        if mon is not None:
            assert _spans(mon) == ROUTED_SPANS
            route = mon.channel("span.service.route")
            assert route.shape == (2, 4)
            np.testing.assert_array_equal(route[:, 2], [3, 3])
            np.testing.assert_array_equal(route[:, 3], [1, 1])
            # the view's form is assembled once, from the three shards
            build = mon.channel("span.service.view_build")
            assert build.shape[0] == 1 and build[0, 2] == 3
            assert mon.count("span.engine.stage") == \
                mon.count("span.engine.cast") == 2
    for ours, plain, want in zip(*answers, _routed_oracle(verb, keys, q)):
        assert ours.dtype == plain.dtype == np.int64
        np.testing.assert_array_equal(ours, plain)
        np.testing.assert_array_equal(ours, want)


def test_lsm_read_through_spill_and_compaction_records_every_span():
    rng = np.random.default_rng(5)
    base = np.sort(rng.integers(0, 2 ** 20, 20_000)).astype(np.float64)
    batches = [rng.integers(0, 2 ** 20, 256).astype(np.float64)
               for _ in range(10)]
    q = np.concatenate([base[::5], batches[-1], rng.integers(
        0, 2 ** 20, 3000).astype(np.float64)])
    answers = []
    for mon in (tel.Monitor(), None):
        svc = LsmIndexService(base, error=32, backend="cuda",
                              memtable_capacity=256, level_fanout=2,
                              monitor=mon, engine_opts=ALL_ON_CPU,
                              assume_sorted=True)
        for keys in batches:
            svc.insert_many(keys)
            svc.publish()
        answers.append([svc.search(q, "left"), svc.search(q, "right"),
                        svc.lookup(q)])
        if mon is None:
            continue
        assert _spans(mon) == LSM_SPANS
        compactions = mon.channel(tel.CH_COMPACT)
        assert compactions.shape[1] == 3 and compactions.shape[0] >= 1
        assert mon.channel(tel.CH_SPILL).shape[1] == 2
        fits = mon.channel("span.lsm.fit")
        levels = fits[:, 2]
        assert 0 in levels and np.any(levels >= 1)
        # the bulk run, every spill and every merge: one fit, one upload
        assert fits.shape[0] == mon.count("span.lsm.upload") == \
            1 + mon.count(tel.CH_SPILL) + compactions.shape[0]
        assert mon.count("span.lsm.merge") == compactions.shape[0]
        # past the bulk run's fit (the first row), a fit at level 1 or
        # deeper is a compaction's, and lies inside its wall
        merged = fits[1:][levels[1:] >= 1]
        assert merged.shape[0] == compactions.shape[0]
        assert np.all(merged[:, 1] <= compactions[:, 2])
        assert mon.count("span.lsm.read") == 3
        assert not {"service.query_mix", "lsm.memtable", "lsm.runs"} & \
            set(mon.channels())
    for ours, plain in zip(*answers):
        assert ours.dtype == plain.dtype
        np.testing.assert_array_equal(ours, plain)
