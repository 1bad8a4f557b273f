"""The port's LSM write plane (``repro_torch.index.lsm``) against the JAX
package's (``repro.index.lsm``).

Both services get the same duplicate-heavy integer keys (made from seeds
with numpy, below 2^24, so every compare is exact in f32), memtable
capacity 64 and fanout 4, and the same calls: inserts across several
spills, deletes (one spill made only of tombstones), upserts, and
``compact()`` until nothing is left to merge.  After each step every verb
equals the reference's answer and a ``np.searchsorted`` oracle of the live
multiset, to tolerance 0, on each of the port's backends -- numpy,
torch-bisect, cuda (its plain twin on the CPU) and dispatch -- and the
manifest (levels, runs and keys per level, version) and ``LsmMetrics`` are
equal.  One case holds the reference's ``pallas`` backend (interpret mode)
against the port's ``cuda`` twin.  A deliberately slowed compaction races
reader threads; replaced runs are released once no reader holds them.
"""
import dataclasses
import gc
import threading
import time
import weakref

import numpy as np
import pytest

from repro.analysis.contracts import LOCK_ORDER as REF_LOCK_ORDER
from repro.index import LsmIndexService as RefLsm
from repro_torch.analysis import LOCK_ORDER
from repro_torch.index import LsmIndexService

CPU = {"device": "cpu"}
ON_CPU = {"cuda": CPU, "torch-bisect": CPU, "torch-window": CPU,
          "dispatch": {**CPU, "small_max": 4, "large_min": 300}}
BACKENDS = ("numpy", "torch-bisect", "cuda", "dispatch")
LIM = 2000                                       # key domain [0, LIM)
KW = {"error": 16, "memtable_capacity": 64, "level_fanout": 4}


class _Oracle:
    """The live multiset as a sorted array: ``delete`` drops every live
    occurrence, ``upsert`` leaves exactly one."""

    def __init__(self, keys):
        self.keys = np.sort(np.asarray(keys, np.float64))

    def insert(self, ks):
        self.keys = np.sort(np.concatenate([self.keys, np.atleast_1d(ks)]))

    def delete(self, k):
        self.keys = self.keys[self.keys != k]

    def upsert(self, k):
        self.delete(k)
        self.insert([k])


def _base(seed=0, n=5000):
    rng = np.random.default_rng(seed)
    return np.sort(rng.integers(0, LIM, n).astype(np.float64))


def _pair(keys, **kw):
    ours = LsmIndexService(keys, engine_opts=ON_CPU, assume_sorted=True,
                           **{**KW, **kw})
    ref = RefLsm(keys, assume_sorted=True, backend="numpy", **{**KW, **kw})
    return ours, ref


def _probes(rng):
    return np.concatenate([np.arange(-2.0, LIM + 2.0),
                           np.floor(rng.uniform(-5, LIM + 5, 300))])


def _verbs(svc, q, backend):
    """Every verb as plain arrays: the vector rank primitive and lookup on
    all probes, the scalar verbs on a few of them."""
    out = [svc.search(q, "left", backend), svc.search(q, "right", backend),
           svc.lookup(q, backend), np.asarray([svc.n_live_keys(backend)])]
    for x in q[::97]:
        x = float(x)
        for res in (svc.point(x, backend), svc.predecessor(x, backend),
                    svc.successor(x, backend)):
            out.append(np.asarray([res.rank, res.found]))
        out.append(np.asarray([svc.count(x, x + 37.0, backend)]))
        r = svc.range(x, x + 53.0, backend)
        out += [np.asarray([r.lo_rank, r.hi_rank]), r.keys]
    return out


def _oracle_verbs(live, q):
    n = live.size
    left, right = np.searchsorted(live, q, "left"), np.searchsorted(live, q,
                                                                    "right")
    out = [left, right, left, np.asarray([n])]     # lookup: leftmost rank
    for x in q[::97]:
        lo, hi = (int(np.searchsorted(live, x, s)) for s in ("left", "right"))
        out += [np.asarray([lo if hi > lo else -1, hi > lo]),
                np.asarray([hi - 1, hi > 0]),
                np.asarray([lo, lo < n])]
        c_hi = int(np.searchsorted(live, x + 37.0, "right"))
        out.append(np.asarray([max(c_hi - lo, 0)]))
        r_hi = int(np.searchsorted(live, x + 53.0, "right"))
        out += [np.asarray([lo, max(r_hi, lo)]), live[lo:r_hi]]
    return out


def _manifest(svc):
    ls = svc.level_set
    return (ls.run_levels(), ls.runs_per_level(), ls.keys_per_level(),
            svc.version, dataclasses.asdict(svc.metrics().lsm))


def _check(ours, ref, oracle, q, backend):
    want = _oracle_verbs(oracle.keys, q)
    for got, ref_got, exp in zip(_verbs(ours, q, backend),
                                 _verbs(ref, q, None), want):
        np.testing.assert_array_equal(got, ref_got)
        np.testing.assert_array_equal(got, exp)
    assert _manifest(ours) == _manifest(ref)


def _steps(svcs, oracle, rng):
    """The four write steps, applied to every service alike; yields each
    step's name once it is done."""
    ins = rng.integers(0, LIM + 100, 700).astype(np.float64)
    for i, k in enumerate(ins):                       # ~11 spills
        for s in svcs:
            s.insert(float(k))
        if i % 150 == 149:
            for s in svcs:
                s.publish()                           # spill + one merge
    oracle.insert(ins)
    yield "inserts"
    for s in svcs:
        s.spill()                                     # memtable now empty
    dels = rng.choice(np.unique(oracle.keys), 80, replace=False)
    for k in dels:                                    # 64 tombstones fill it:
        for s in svcs:                                # the next delete spills
            s.delete(float(k))                        # a tombstone-only run
        oracle.delete(k)
    assert any(r.n_keys == 0 and r.tombstones.size
               for r in svcs[0].level_set.runs)
    yield "deletes"
    ups = np.concatenate([rng.choice(oracle.keys, 90),
                          rng.integers(0, LIM, 30).astype(np.float64)])
    for k in ups:
        for s in svcs:
            s.upsert(float(k))
        oracle.upsert(k)
    yield "upserts"
    for s in svcs:
        s.spill()
        while s.compact(max_steps=4):
            pass
        assert s.compactor.pick(s.level_set.runs) is None
    yield "compacted"


@pytest.mark.parametrize("backend", BACKENDS)
def test_every_verb_equals_the_reference_and_the_oracle(backend):
    base = _base(seed=1)
    ours, ref = _pair(base)
    oracle = _Oracle(base)
    rng = np.random.default_rng(2)
    q = _probes(rng)
    _check(ours, ref, oracle, q, backend)
    done = []
    for step in _steps((ours, ref), oracle, rng):
        _check(ours, ref, oracle, q, backend)
        done.append(step)
    assert done == ["inserts", "deletes", "upserts", "compacted"]
    assert ours.metrics().lsm.compactions >= 3


def test_reference_pallas_backend_equals_the_cuda_twin():
    """The reference's Pallas kernel (interpret mode) on every run against
    the port's cuda backend (its plain twin on the CPU): a spilled run
    whose tombstones shadow the bulk run, and live memtable tombstones."""
    base = _base(seed=3, n=1500)
    ours, ref = _pair(base)
    rng = np.random.default_rng(4)
    ins = rng.integers(0, LIM, 54).astype(np.float64)
    for s in (ours, ref):
        for k in base[::150]:
            s.delete(float(k))
        s.insert_many(ins)
        s.spill()
        for k in base[75::150]:
            s.delete(float(k))
    assert ours.level_set.runs_per_level() == \
        ref.level_set.runs_per_level() == (1, 0, 0, 1)
    q = np.concatenate([base[::75], np.floor(rng.uniform(-3, LIM + 3, 28))])
    for side in ("left", "right"):
        np.testing.assert_array_equal(ours.search(q, side, "cuda"),
                                      ref.search(q, side, "pallas"))


def test_payload_newest_wins_like_the_reference():
    keys = np.arange(200, dtype=np.float64)
    ours, ref = _pair(keys, payload=keys * 10)
    for s in (ours, ref):
        s.upsert(5.0, 999.0)
        for k in range(100, 180):
            s.insert(float(k), float(k) + 0.5)
        s.spill()
    for lo, hi in ((3.0, 7.0), (99.0, 102.0)):
        for backend in BACKENDS:
            got, want = ours.range(lo, hi, backend), ref.range(lo, hi)
            np.testing.assert_array_equal(got.keys, want.keys)
            np.testing.assert_array_equal(got.payload, want.payload)
    while ours.compact(4) + ref.compact(4):
        pass
    np.testing.assert_array_equal(ours.range(3.0, 7.0, "cuda").payload,
                                  [30.0, 40.0, 999.0, 60.0, 70.0])


def test_slow_compaction_racing_readers_keeps_answers_exact():
    """A compaction held open inside its merge races four reader threads
    and a spilling writer above the probe range: compaction never changes
    the live multiset, so every answer, before, during and after the swap,
    equals the oracle."""
    base = _base(seed=5, n=3000)
    svc = LsmIndexService(base, engine_opts=ON_CPU, assume_sorted=True,
                          **KW)
    rng = np.random.default_rng(6)
    low = rng.integers(0, LIM, 5 * 64).astype(np.float64)
    svc.insert_many(low)
    oracle = _Oracle(base)
    oracle.insert(low)
    assert svc.compactor.pick(svc.level_set.runs) is not None
    q = _probes(rng)
    want = {s: np.searchsorted(oracle.keys, q, s) for s in ("left", "right")}
    in_merge, release, stop = (threading.Event() for _ in range(3))
    failures, reads = [], []

    def hook():
        in_merge.set()
        if not release.wait(20.0):
            failures.append("merge hook never released")

    def reader(seed):
        r = np.random.default_rng(seed)
        while not stop.is_set():
            side = ("left", "right")[int(r.integers(2))]
            backend = BACKENDS[int(r.integers(len(BACKENDS)))]
            got = svc.search(q, side, backend)
            if not np.array_equal(got, want[side]):
                failures.append((side, backend))
            reads.append(side)

    svc.compactor._merge_hook = hook
    merger = threading.Thread(target=svc.compact, daemon=True)
    readers = [threading.Thread(target=reader, args=(s,), daemon=True)
               for s in range(4)]
    merger.start()
    for t in readers:
        t.start()
    try:
        assert in_merge.wait(20.0)
        svc.insert_many(np.full(64, LIM + 500.0))      # above every probe
        svc.spill()
        deadline = time.monotonic() + 20.0
        while len(reads) < 12 and time.monotonic() < deadline:
            time.sleep(0.005)                          # readers mid-merge
        during = len(reads)
    finally:
        release.set()
    merger.join(20.0)
    assert not merger.is_alive()
    svc.compactor._merge_hook = None
    while svc.compact(max_steps=4):
        pass
    seen = len(reads)
    deadline = time.monotonic() + 20.0
    while len(reads) < seen + 4 and time.monotonic() < deadline:
        time.sleep(0.005)                              # readers after swap
    stop.set()
    for t in readers:
        t.join(20.0)
    assert not any(t.is_alive() for t in readers)
    assert not failures, failures[:3]
    assert during >= 12 and len(reads) > during
    assert svc.metrics().lsm.compactions >= 1
    for side in ("left", "right"):
        np.testing.assert_array_equal(svc.search(q, side, "cuda"), want[side])


def test_replaced_runs_are_released_once_no_reader_holds_them():
    """After a compaction the merged-away runs (and their tables, which
    carry the device forms) are freed; a pinned manifest keeps its own
    generation alive until it is dropped, and reshadowing keeps none."""
    base = _base(seed=7, n=2000)
    svc = LsmIndexService(base, engine_opts=ON_CPU, assume_sorted=True,
                          **KW)
    rng = np.random.default_rng(8)
    svc.insert_many(rng.integers(0, LIM, 4 * 64).astype(np.float64))
    svc.spill()
    svc.search(base[:8], "left", "torch-bisect")   # a second device form
    group = svc.compactor.pick(svc.level_set.runs)
    assert group is not None and len(group) == 4
    tables = [weakref.ref(r.snapshot.table) for r in group]
    assert all(t()._device_cache for t in tables)
    pinned = svc.level_set
    del group
    assert svc.compact() == 4
    gc.collect()
    assert all(t() is not None for t in tables)    # the pinned manifest
    del pinned
    gc.collect()
    assert all(t() is None for t in tables)


def test_raw_knob_backend_default_is_the_card():
    """Raw knobs serve on the CUDA card (the reference defaults to numpy):
    the bulk run builds its engine at construction, so without a card (and
    without ``engine_opts`` placing it on the CPU) construction raises."""
    base = _base(seed=9, n=500)
    svc = LsmIndexService(base, engine_opts=ON_CPU, **KW)
    assert svc.default_backend == svc.plan.backend == "cuda"
    assert RefLsm(base, **KW).default_backend == "numpy"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LsmIndexService(base, **KW)
    empty = LsmIndexService(None, **KW)            # no run, nothing built
    np.testing.assert_array_equal(empty.search(base[:4], "left", "numpy"),
                                  np.zeros(4, np.int64))


def test_lock_order_is_the_reference_order_restricted_to_the_port():
    assert set(LOCK_ORDER) <= set(REF_LOCK_ORDER)
    assert list(LOCK_ORDER) == [n for n in REF_LOCK_ORDER if n in LOCK_ORDER]
    assert {"Compactor._lock", "LsmIndexService._write_lock",
            "AsyncIndexService._lock", "Memtable._lock",
            "LsmIndexService._counts_lock"} <= set(LOCK_ORDER)
    # the device-sharded plane is ported: its two locks join at their ranks
    assert {"DeviceShardedService._write_lock",
            "DeviceShardedService._counts_lock"} <= set(LOCK_ORDER)


def test_background_compactor_merges_until_close():
    """``background_compaction=True`` runs the compactor on its own daemon
    cadence (no publish needed); ``close`` stops it; answers stay exact."""
    base = _base(seed=11, n=1000)
    new = np.random.default_rng(12).integers(0, LIM, 5 * 64).astype(
        np.float64)
    with LsmIndexService(base, engine_opts=ON_CPU, assume_sorted=True,
                         background_compaction=True, compact_interval_s=0.01,
                         **KW) as svc:
        svc.insert_many(new)
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline and \
                svc.metrics().lsm.compactions < 1:
            time.sleep(0.01)
    assert svc.compactor._thread is None
    assert svc.metrics().lsm.compactions >= 1
    live = np.sort(np.concatenate([base, new]))
    q = _probes(np.random.default_rng(13))
    for side in ("left", "right"):
        np.testing.assert_array_equal(svc.search(q, side, "cuda"),
                                      np.searchsorted(live, q, side))
