"""The port's sharded serving (``repro_torch.index.sharded``) and
``IndexService`` against the JAX package's.

Both services get the same keys, inserts and calls (made from seeds with
numpy; integer keys, so every compare is exact in f32).  After insert ->
publish, every verb on each of the port's backends -- numpy, torch-bisect,
cuda (here its plain twin on the CPU) and dispatch -- equals the reference
service's answer and ``np.searchsorted`` on the merged column, to
tolerance 0; one small case holds the reference's ``pallas`` backend (in
interpret mode) against the port's ``cuda`` twin.  Rebalance boundaries,
epochs, ``apply_plan`` and the ``metrics()`` tree are equal too.
"""
import dataclasses

import numpy as np
import pytest

from repro.index import IndexPlan as RefPlan
from repro.index import ShardedIndexService as RefSharded
from repro.index import pack_shard_tables as ref_pack
from repro.serve import IndexService as RefService
from repro_torch.analysis import sanitizer
from repro_torch.index import IndexPlan, pack_shard_tables, sharded
from repro_torch.serve import IndexService, ShardedIndexService

CPU = {"device": "cpu"}
ON_CPU = {"cuda": CPU, "torch-bisect": CPU, "torch-window": CPU,
          "dispatch": {**CPU, "small_max": 4, "large_min": 300}}
BACKENDS = ("numpy", "torch-bisect", "cuda", "dispatch")


def _dup_heavy_keys(n, seed=0, max_run=6, lim=2 ** 20):
    """tests/test_rebalance.py's keys: integer runs of length <= max_run."""
    rng = np.random.default_rng(seed)
    uniq = np.sort(rng.choice(lim, size=n // 2, replace=False))
    reps = rng.integers(1, max_run + 1, size=uniq.shape[0])
    return np.repeat(uniq, reps)[:n].astype(np.float64)


def _pair(keys, **kw):
    ours = ShardedIndexService(keys, engine_opts=ON_CPU, assume_sorted=True,
                               **kw)
    ref = RefSharded(keys, assume_sorted=True,
                     **{**kw, "backend": kw.get("backend", "numpy")})
    return ours, ref


def _insert(svcs, keys):
    for k in keys:
        for s in svcs:
            s.insert(float(k))


def _verbs(svc, q, backend):
    """Every verb of the query plane, as plain arrays."""
    pt = svc.point(q, backend=backend)
    pr = svc.predecessor(q, backend=backend)
    sc = svc.successor(q, backend=backend)
    out = [svc.search(q, "left", backend=backend),
           svc.search(q, "right", backend=backend),
           svc.lookup(q, backend=backend), pt.rank, pt.found, pr.rank,
           pr.found, sc.rank, sc.found,
           svc.count(q, q + 40, backend=backend)]
    for lo, hi in ((q[0], q[0] + 3000), (q[-1], q[-1] - 1), (-5.0, 2.0 ** 21)):
        r = svc.range(float(lo), float(hi), backend=backend)
        out += [np.asarray([r.lo_rank, r.hi_rank]), r.keys]
    return out


def _oracle(merged, q):
    left = np.searchsorted(merged, q, "left")
    right = np.searchsorted(merged, q, "right")
    n = merged.shape[0]
    found = (left < n) & (merged[np.minimum(left, n - 1)] == q)
    return left, right, np.where(found, left, -1)


def _queries(keys, rng, size):
    return np.concatenate([keys[rng.integers(0, keys.shape[0], size)],
                           np.floor(rng.uniform(-3, 2 ** 20 + 3, size // 3))])


@pytest.mark.parametrize("backend", BACKENDS)
def test_every_verb_equals_the_reference_after_insert_and_publish(backend):
    keys = _dup_heavy_keys(6000, seed=5)
    ours, ref = _pair(keys, error=32, n_shards=4, buffer_size=8)
    rng = np.random.default_rng(6)
    new = np.concatenate([keys[rng.integers(0, keys.shape[0], 500)],
                          rng.integers(0, 2 ** 20, 300).astype(np.float64)])
    _insert((ours, ref), new)
    assert sorted(ours.publish()) == sorted(ref.publish())
    merged = np.sort(np.concatenate([keys, new]))
    for size in (1, 7, 400):
        q = _queries(merged, rng, size)
        for got, want in zip(_verbs(ours, q, backend), _verbs(ref, q, None)):
            np.testing.assert_array_equal(got, want)
        left, right, hit = _oracle(merged, q)
        np.testing.assert_array_equal(ours.search(q, "left", backend), left)
        np.testing.assert_array_equal(ours.search(q, "right", backend),
                                      right)
        np.testing.assert_array_equal(ours.lookup(q, backend), hit)
    assert ours.epochs() == ref.epochs()


def test_reference_pallas_backend_equals_the_cuda_twin():
    """The reference's Pallas kernel (interpret mode) against the port's
    cuda backend (its plain twin on the CPU): the rank primitive on both
    sides and the point lookup, across two shards."""
    keys = _dup_heavy_keys(1500, seed=7)
    ours, ref = _pair(keys, error=16, n_shards=2, buffer_size=4)
    rng = np.random.default_rng(8)
    _insert((ours, ref), rng.integers(0, 2 ** 20, 60).astype(np.float64))
    ours.publish(), ref.publish()
    q = _queries(keys, rng, 48)

    def answers(svc, backend):
        pt = svc.point(q, backend=backend)
        return [svc.search(q, "left", backend), svc.search(q, "right", backend),
                svc.lookup(q, backend), pt.rank, pt.found]

    for got, want in zip(answers(ours, "cuda"), answers(ref, "pallas")):
        np.testing.assert_array_equal(got, want)


def test_publish_touches_only_dirty_shards_like_the_reference():
    keys = _dup_heavy_keys(6000, seed=42)
    ours, ref = _pair(keys, error=64, n_shards=3, buffer_size=16)
    np.testing.assert_array_equal(ours.boundaries, ref.boundaries)
    mid = np.arange(8) + ours.boundaries[1] + 0.5
    _insert((ours, ref), np.floor(mid))
    before = [h.current() for h in ours.handles]
    assert list(ours.publish()) == list(ref.publish()) == [1]
    assert ours.epochs() == ref.epochs() == [1, 2, 1]
    assert ours.handles[0].current() is before[0]
    assert ours.handles[2].current() is before[2]
    assert ours.publish() == {} and ref.publish() == {}
    assert sorted(ours.publish(shards=[0, 2], force=True)) == \
        sorted(ref.publish(shards=[0, 2], force=True))
    assert ours.epochs() == ref.epochs() == [2, 2, 2]


def test_rebalance_equals_the_reference():
    """Skewed inserts, then rebalance: the same recut boundaries, moved
    keys, epochs, ShardSet version and answers; payloads travel along."""
    rng = np.random.default_rng(21)
    base = np.sort(rng.choice(2 ** 20, size=4000, replace=False)
                   ).astype(np.float64)
    pl = (base * 3).astype(np.int64)
    ours = ShardedIndexService(base, error=64, n_shards=4, buffer_size=16,
                               payload=pl, skew_threshold=1.5,
                               engine_opts=ON_CPU, assume_sorted=True)
    ref = RefSharded(base, error=64, n_shards=4, buffer_size=16, payload=pl,
                     skew_threshold=1.5, backend="numpy",
                     assume_sorted=True)
    hot = np.setdiff1d(np.arange(0, int(ours.boundaries[1]), 3,
                                 dtype=np.float64), base)[:1500]
    for k in hot:
        ours.insert(float(k), int(k) * 3)
        ref.insert(float(k), int(k) * 3)
    ours.publish(), ref.publish()
    assert ours.imbalance() == ref.imbalance() > 1.5
    np.testing.assert_array_equal(ours.shard_loads(), ref.shard_loads())
    got, want = ours.rebalance(), ref.rebalance()
    assert got == want and got["moved_keys"] > 0
    np.testing.assert_array_equal(ours.boundaries, ref.boundaries)
    assert ours.epochs() == ref.epochs()
    assert ours.shard_set.version == ref.shard_set.version == 2
    assert ours.rebalance() is None and ref.rebalance() is None
    q = np.concatenate([hot[::11], base[::101]])
    for backend in BACKENDS:
        for a, b in zip(_verbs(ours, q, backend), _verbs(ref, q, None)):
            np.testing.assert_array_equal(a, b)
        r = ours.range(float(hot[3]), float(hot[900]), backend=backend)
        np.testing.assert_array_equal(r.payload, r.keys.astype(np.int64) * 3)


def test_auto_publish_and_auto_rebalance_equal_the_reference():
    rng = np.random.default_rng(13)
    base = np.sort(rng.choice(2 ** 20, size=4000, replace=False)
                   ).astype(np.float64)
    kw = dict(error=64, n_shards=4, buffer_size=16, skew_threshold=1.3,
              auto_rebalance=True, publish_every=512)
    ours, ref = _pair(base, **kw)
    hot = np.setdiff1d(np.arange(0, 2 ** 18, 7, dtype=np.float64),
                       base)[:2500]
    _insert((ours, ref), hot)
    ours.publish(), ref.publish()
    m, r = ours.metrics(), ref.metrics()
    assert m.rebalances == r.rebalances >= 1
    assert dataclasses.asdict(m) == dataclasses.asdict(r)


def test_apply_plan_equals_the_reference():
    """A thresholds-only swap keeps the snapshots; a structural one
    (error, shard count) re-partitions -- both exactly as the reference."""
    keys = _dup_heavy_keys(8000, seed=23)
    ours, ref = _pair(keys, error=64, n_shards=4, buffer_size=16,
                      backend="dispatch")
    _insert((ours, ref), np.arange(100, 5000, 37, dtype=np.float64))
    snaps = [h.current() for h in ours.handles]
    light = ours.apply_plan(ours.plan.replace(small_max=8, large_min=64))
    ref_light = ref.apply_plan(ref.plan.replace(small_max=8, large_min=64))
    assert [h.current() for h in ours.handles] == snaps
    assert ours.handles[0].engine("dispatch").large_min == 64
    for plan, ref_plan in ((light, ref_light),
                           (ours.apply_plan(ours.plan.replace(
                               error=32, n_shards=3, buffer_size=8)),
                            ref.apply_plan(ref.plan.replace(
                                error=32, n_shards=3, buffer_size=8)))):
        assert (plan.error, plan.n_shards, plan.buffer_size, plan.revision,
                plan.small_max, plan.large_min) == \
            (ref_plan.error, ref_plan.n_shards, ref_plan.buffer_size,
             ref_plan.revision, ref_plan.small_max, ref_plan.large_min)
        np.testing.assert_array_equal(ours.boundaries, ref.boundaries)
        assert ours.epochs() == ref.epochs()
        assert ours.shard_set.version == ref.shard_set.version
        q = _queries(keys, np.random.default_rng(plan.revision), 200)
        for backend in BACKENDS:
            for a, b in zip(_verbs(ours, q, backend),
                            _verbs(ref, q, "numpy")):
                np.testing.assert_array_equal(a, b)
    assert dataclasses.asdict(ours.metrics()) == \
        dataclasses.asdict(ref.metrics())


def test_index_service_equals_the_reference():
    keys = _dup_heavy_keys(3000, seed=8)
    ours = IndexService(keys, error=64, buffer_size=16, engine_opts=ON_CPU,
                        assume_sorted=True)
    ref = RefService(keys, error=64, buffer_size=16, backend="numpy",
                     assume_sorted=True)
    assert ours.default_backend == "cuda" and ours.plan.backend == "cuda"
    assert ours.publish() is ours.handle.current()          # no-op: clean
    new = np.arange(1, 2 ** 20, 4099, dtype=np.float64)
    _insert((ours, ref), new)
    assert ours.pending_inserts == ref.pending_inserts == new.size
    assert ours.publish().epoch == ref.publish().epoch == ours.epoch == 2
    q = _queries(np.sort(np.concatenate([keys, new])),
                 np.random.default_rng(9), 300)
    for backend in BACKENDS:
        for a, b in zip(_verbs(ours, q, backend), _verbs(ref, q, None)):
            np.testing.assert_array_equal(a, b)
    assert dataclasses.asdict(ours.metrics()) == \
        dataclasses.asdict(ref.metrics())
    one = IndexService.from_plan(keys, IndexPlan(error=64, n_shards=4,
                                                 buffer_size=16),
                                 engine_opts=ON_CPU, assume_sorted=True)
    ref_one = RefService.from_plan(keys, RefPlan(error=64, n_shards=4,
                                                 buffer_size=16),
                                   assume_sorted=True)
    assert one.plan.n_shards == ref_one.plan.n_shards == 1


@pytest.mark.parametrize("backend", ["dispatch", "cuda"])
def test_one_shard_service_answers_unrouted_like_the_reference(backend,
                                                               monkeypatch):
    """A one-shard ``IndexService`` answers every verb without routing:
    batches either side of dispatch's tier crossing (numpy at 3 queries, the
    device tiers above), f64 queries below the first key, above the last and
    repeated, a 2-D batch and int64 queries each equal the reference's
    service and ``np.searchsorted`` bit for bit, and ``metrics()`` too."""
    routed = []
    monkeypatch.setattr(sharded, "route_keys",
                        lambda b, q: routed.append(np.shape(q)) or
                        np.zeros(np.shape(q), np.int64))
    keys = _dup_heavy_keys(4000, seed=11)
    ours = IndexService(keys, error=64, buffer_size=16, backend=backend,
                        engine_opts=ON_CPU, assume_sorted=True)
    ref = RefService(keys, error=64, buffer_size=16, backend="numpy",
                     assume_sorted=True)
    rng = np.random.default_rng(12)
    edge = np.array([keys[0] - 1, keys[0], keys[-1], keys[-1] + 1, -2.0 ** 30,
                     2.0 ** 40, keys[7], keys[7]])
    big = _queries(keys, rng, 600)
    batches = [edge[:3], edge, _queries(keys, rng, 40), big,
               big[:600].reshape(20, 30), big.astype(np.int64),
               np.concatenate([big, [2 ** 53 + 1, -(2 ** 60) - 3]]).astype(
                   np.int64)]
    for q in batches:
        left = np.searchsorted(keys, q, "left")
        right = np.searchsorted(keys, q, "right")
        for side, want in (("left", left), ("right", right)):
            got = ours.search(q, side)
            assert got.dtype == np.int64 and got.shape == np.shape(q)
            np.testing.assert_array_equal(got, ref.search(q, side))
            np.testing.assert_array_equal(got, want)
        found = (left < keys.size) & (keys[np.minimum(left, keys.size - 1)]
                                      == np.asarray(q, np.float64))
        pt, pt_ref = ours.point(q), ref.point(q)
        assert pt.rank.dtype == np.int64 and pt.rank.shape == np.shape(q)
        np.testing.assert_array_equal(pt.rank, np.where(found, left, -1))
        np.testing.assert_array_equal(pt.found, found)
        hit = ours.lookup(q)
        assert hit.dtype == np.int64 and hit.shape == np.shape(q)
        np.testing.assert_array_equal(hit, ref.lookup(q))
        np.testing.assert_array_equal(hit, np.where(found, left, -1))
        for a, b in ((pt, pt_ref), (ours.predecessor(q), ref.predecessor(q)),
                     (ours.successor(q), ref.successor(q))):
            np.testing.assert_array_equal(a.rank, b.rank)
            np.testing.assert_array_equal(a.found, b.found)
        count = ours.count(q, q + 40)
        np.testing.assert_array_equal(count, ref.count(q, q + 40))
        np.testing.assert_array_equal(count, np.maximum(np.searchsorted(
            keys, np.asarray(q, np.float64) + 40, "right") - left, 0))
    assert routed == []
    for lo, hi in ((-5.0, keys[0]), (keys[3], keys[3]), (keys[100], 2.0 ** 30),
                   (keys[-1] + 1, 2.0 ** 40)):
        got, want = ours.range(lo, hi), ref.range(lo, hi)
        assert (got.lo_rank, got.hi_rank) == (want.lo_rank, want.hi_rank) == (
            np.searchsorted(keys, lo, "left"),
            np.searchsorted(keys, hi, "right"))
        np.testing.assert_array_equal(got.keys, want.keys)
    assert dataclasses.asdict(ours.metrics()) == \
        dataclasses.asdict(ref.metrics())


def test_index_service_is_the_sharded_service_at_one_shard():
    """``IndexService`` is ``ShardedIndexService`` with one shard through a
    plan and ``apply_plan``, equal to the reference's service there, and its
    deprecated ``stats()`` / ``service_stats()`` warn under its own name and
    equal the reference's."""
    keys = _dup_heavy_keys(3000, seed=13)
    ours = IndexService.from_plan(
        keys, IndexPlan(error=32, n_shards=3, buffer_size=8),
        engine_opts=ON_CPU, assume_sorted=True)
    ref = RefService.from_plan(
        keys, RefPlan(error=32, n_shards=3, buffer_size=8),
        assume_sorted=True)
    assert isinstance(ours, ShardedIndexService)
    assert not hasattr(ours, "_sharded")
    assert ours.n_shards == ours.plan.n_shards == 1
    plan = ours.apply_plan(ours.plan.replace(error=16, n_shards=4))
    ref_plan = ref.apply_plan(ref.plan.replace(error=16, n_shards=4))
    assert (plan.error, plan.n_shards) == \
        (ref_plan.error, ref_plan.n_shards) == (16, 1)
    assert ours.n_shards == 1 and ours.epoch == ref.epoch == 1
    assert ours.tree is ours.writers[0] and ours.handle is ours.handles[0]
    with pytest.warns(DeprecationWarning, match=r"^IndexService\.stats\(\)"):
        got = ours.stats()
    with pytest.warns(DeprecationWarning):
        want = ref.stats()
    assert [dataclasses.asdict(s) for s in got] == \
        [dataclasses.asdict(s) for s in want]
    with pytest.warns(DeprecationWarning,
                      match=r"^IndexService\.service_stats\(\)"):
        got = ours.service_stats()
    with pytest.warns(DeprecationWarning):
        assert got == ref.service_stats()


def test_services_default_to_the_card():
    """Raw-knob services serve on the CUDA card: without one (here) the
    default backend raises instead of running anywhere else."""
    keys = _dup_heavy_keys(2000, seed=1)
    for svc in (ShardedIndexService(keys, error=32, assume_sorted=True),
                IndexService(keys, error=32, assume_sorted=True)):
        assert svc.default_backend == "cuda"
        with pytest.raises(RuntimeError, match="no CUDA device"):
            svc.search(keys[:4])
        np.testing.assert_array_equal(svc.search(keys[:4], "left", "numpy"),
                                      np.searchsorted(keys, keys[:4]))


def test_pack_shard_tables_equals_the_reference():
    keys = _dup_heavy_keys(5000, seed=3)
    ours, ref = _pair(keys, error=16, n_shards=4)
    got = pack_shard_tables([h.current().table for h in ours.handles])
    want = ref_pack([h.current().table for h in ref.handles])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        got.seg_start[0, 0] = 1.0            # published: frozen


def test_a_verb_that_sees_two_shard_sets_raises_under_the_sanitizer():
    keys = _dup_heavy_keys(2000, seed=4)
    svc = ShardedIndexService(keys, error=32, n_shards=2, buffer_size=4,
                              engine_opts=ON_CPU, assume_sorted=True)
    prev = sanitizer.set_enabled(True)
    try:
        with sanitizer.pin_scope("lookup"):
            svc.lookup(keys[:8], "numpy")         # pins version 1 once
        with pytest.raises(sanitizer.PinViolation, match="versions"):
            with sanitizer.pin_scope("torn-verb"):
                svc._pin_shard_set()
                svc.rebalance(force=True)         # version bump mid-verb
                svc._pin_shard_set()              # sees the new set
        sanitizer.observe_pin(3)                  # outside a scope: no-op
    finally:
        sanitizer.set_enabled(prev)


def _same_state(a, b):
    """Two services' whole state: routing view, pending counts, epochs,
    every writer's tree, every installed snapshot and ``metrics()``."""
    a, b = getattr(a, "_sharded", a), getattr(b, "_sharded", b)
    assert a._pending == b._pending
    assert a.epochs() == b.epochs()
    assert a.shard_set.version == b.shard_set.version
    np.testing.assert_array_equal(a.boundaries, b.boundaries)
    for wa, wb in zip(a.writers, b.writers, strict=True):
        np.testing.assert_array_equal(wa.start_keys, wb.start_keys)
        np.testing.assert_array_equal(wa.slopes, wb.slopes)
        assert len(wa.pages) == len(wb.pages)
        for pa, pb in zip(wa.pages, wb.pages):
            np.testing.assert_array_equal(pa, pb)
        assert wa.buffers == wb.buffers
        assert wa.buf_payloads == wb.buf_payloads
        if wa.payloads is not None:
            for pa, pb in zip(wa.payloads, wb.payloads, strict=True):
                np.testing.assert_array_equal(pa, pb)
        np.testing.assert_array_equal(wa.router.levels[-1],
                                      wb.router.levels[-1])
        assert wa.dirty_segments() == wb.dirty_segments()
    for ha, hb in zip(a.handles, b.handles, strict=True):
        sa, sb = ha.current(), hb.current()
        assert (sa.epoch, sa.n_refit) == (sb.epoch, sb.n_refit)
        for f in ("keys", "start_key", "slope", "base", "seg_end"):
            np.testing.assert_array_equal(getattr(sa.table, f),
                                          getattr(sb.table, f))
        if sa.payload is not None:
            np.testing.assert_array_equal(sa.payload, sb.payload)
    assert dataclasses.asdict(a.metrics()) == dataclasses.asdict(b.metrics())


# (n_shards, payload, publish_every, auto_rebalance, below the first key,
#  batch sizes); n_shards 1 is the one-shard IndexService
INSERT_MANY_CASES = [
    (4, False, None, False, False, (1, 60, 900)),
    (4, True, None, False, True, (400, 400)),
    (3, False, 256, False, False, (100, 1000, 5)),  # the cadence mid-batch
    (3, True, 97, False, True, (700,)),
    (4, False, 512, True, False, (2600,)),  # a publish there rebalances
    (1, False, 200, False, True, (450, 30)),
    (1, True, None, False, False, (300,)),
]


@pytest.mark.parametrize(
    "n_shards,payload,publish_every,auto_rebalance,below,batches",
    INSERT_MANY_CASES)
def test_insert_many_leaves_the_per_key_loops_state(
        n_shards, payload, publish_every, auto_rebalance, below, batches):
    """``insert_many`` equals ``insert`` key by key on the port and on the
    JAX package: buffers, pending counts, auto-publishes at the same key
    (epochs, snapshots), a rebalance inside one, ``metrics()``."""
    rng = np.random.default_rng(n_shards * 100 + len(batches))
    keys = np.sort(rng.choice(2 ** 20, size=6000, replace=False)
                   ).astype(np.float64)
    pl = (keys * 3).astype(np.int64) if payload else None
    kw = dict(error=32, buffer_size=8, publish_every=publish_every,
              payload=pl, assume_sorted=True)
    if n_shards == 1:
        make = lambda: IndexService(keys, engine_opts=ON_CPU, **kw)  # noqa
        ref = RefService(keys, backend="numpy", **kw)
    else:
        kw.update(n_shards=n_shards, auto_rebalance=auto_rebalance,
                  skew_threshold=1.3)
        make = lambda: ShardedIndexService(keys, engine_opts=ON_CPU,  # noqa
                                           **kw)
        ref = RefSharded(keys, backend="numpy", **kw)
    loop, batch = make(), make()
    if auto_rebalance:          # a hot range: one shard outgrows the rest
        new = np.setdiff1d(np.arange(0, 2 ** 18, 7, dtype=np.float64),
                           keys)[:sum(batches)]
    else:
        new = np.concatenate([keys[rng.integers(0, keys.size, 600)],
                              np.floor(rng.uniform(0, 2 ** 20, 900))])
        if below:
            new = np.concatenate([new, keys[0] - 1 - np.arange(30.0)])
        rng.shuffle(new)
    vals = (-np.arange(new.size) - 1) if payload else None
    a = 0
    for size in batches:
        part = new[a:a + size]
        for i, k in enumerate(part):
            v = None if vals is None else int(vals[a + i])
            loop.insert(float(k), v)
            ref.insert(float(k), v)
        batch.insert_many(part, None if vals is None else
                          vals[a:a + size].tolist())
        a += size
        _same_state(batch, loop)
        assert batch.pending_inserts == ref.pending_inserts
        assert dataclasses.asdict(batch.metrics()) == \
            dataclasses.asdict(ref.metrics())
    if publish_every is not None:
        assert max(getattr(batch, "_sharded", batch).epochs()) > 1
    if auto_rebalance:
        assert batch.metrics().rebalances >= 1
    batch.publish(), loop.publish(), ref.publish()
    _same_state(batch, loop)
    merged = np.sort(np.concatenate([keys, new[:a]]))
    q = _queries(merged, rng, 300)
    left, right, hit = _oracle(merged, q)
    np.testing.assert_array_equal(batch.search(q, "left"), left)
    np.testing.assert_array_equal(batch.search(q, "right"), right)
    np.testing.assert_array_equal(batch.lookup(q), hit)


def test_insert_many_refuses_what_insert_refuses():
    keys = _dup_heavy_keys(2000, seed=3)
    ro = ShardedIndexService(keys, error=32, n_shards=2, engine_opts=ON_CPU,
                             assume_sorted=True)
    with pytest.raises(ValueError, match="read-only"):
        ro.insert_many(keys[:4])
    svc = ShardedIndexService(keys, error=32, n_shards=2, buffer_size=4,
                              engine_opts=ON_CPU, assume_sorted=True)
    with pytest.raises(ValueError, match="payloads"):
        svc.insert_many(keys[:2], [1, 2])
    assert svc.pending_inserts == 0


class _CountingLock:
    """A lock wrapper counting outermost acquisitions."""

    def __init__(self, lock):
        self.lock, self.depth, self.outer = lock, 0, 0

    def __enter__(self):
        self.lock.__enter__()
        self.depth += 1
        self.outer += self.depth == 1
        return self

    def __exit__(self, *exc):
        self.depth -= 1
        return self.lock.__exit__(*exc)


def test_insert_many_takes_the_write_lock_once_in_the_declared_order():
    """Under the sanitizer's watchdog a batch that crosses three
    auto-publishes takes ``_write_lock`` once (the loop: once a key), and
    every lock taken under it comes later in ``LOCK_ORDER``."""
    from repro_torch.analysis.contracts import LOCK_RANK
    from repro_torch.index.telemetry import Monitor
    prev = sanitizer.set_enabled(True)
    try:
        keys = _dup_heavy_keys(4000, seed=12)
        svc = ShardedIndexService(keys, error=32, n_shards=3, buffer_size=8,
                                  publish_every=100, engine_opts=ON_CPU,
                                  assume_sorted=True, monitor=Monitor())
        assert type(svc._write_lock).__name__ == "_SanitizedLock"
        svc._write_lock = _CountingLock(svc._write_lock)
        svc.insert_many(np.arange(1.0, 2 ** 20, 2 ** 20 / 350))
        assert svc._write_lock.outer == 1
        assert svc.monitor.count("service.publish") == 3
        assert svc.pending_inserts == 50
        for held, taken in sanitizer.lock_graph_edges():
            if held == "ShardedIndexService._write_lock":
                assert LOCK_RANK[taken] > LOCK_RANK[held], taken
    finally:
        sanitizer.set_enabled(prev)


@pytest.mark.parametrize("backend", BACKENDS)
def test_publishes_refit_where_the_tables_serve_and_tag_it(backend):
    """Each shard's publisher re-fits on its tables' device (here the host,
    for every backend), and a ``tree.flush`` row carries the runs re-fit
    and, second, those fitted on a card: 0 on the host.  The published
    tables are the reference service's, through a rebalance too."""
    from repro_torch.index.telemetry import Monitor
    keys = _dup_heavy_keys(6000, seed=13)
    kw = dict(error=32, n_shards=3, buffer_size=8, assume_sorted=True)
    ours = ShardedIndexService(keys, backend=backend, engine_opts=ON_CPU,
                               monitor=Monitor(), **kw)
    ref = RefSharded(keys, backend="numpy", **kw)
    assert all(p.device.type == "cpu" for p in ours.publishers)
    new = np.random.default_rng(14).integers(0, 2 ** 20, 900).astype(float)
    for svc in (ours, ref):
        for k in new:
            svc.insert(float(k))
        svc.publish()
        svc.rebalance(force=True)
        for k in new[::3] + 0.5:
            svc.insert(float(k))
        svc.publish()
    rows = ours.monitor.channel("span.tree.flush")
    assert rows.shape[1] == 4 and rows[:, 2].sum() > 0
    assert not rows[:, 3].any()
    for a, b in zip(ours.handles, ref.handles):
        t, r = a.current().table, b.current().table
        for f in ("start_key", "slope", "base", "seg_end", "keys"):
            np.testing.assert_array_equal(getattr(t, f), getattr(r, f))


# ------------------------------------------ the view: one engine past a shard
def _routed_oracle(svc, q, answer, backend):
    """A read the way the service routed it before its view: each query to
    its owning shard by the cuts, that shard's own engine's local answer
    lifted by the preceding snapshots' key counts, a miss kept -1."""
    ss = svc.shard_set
    snaps = [h.current() for h in ss.handles]
    offsets = np.cumsum([0] + [s.n_keys for s in snaps[:-1]])
    q = np.asarray(q, np.float64)
    sid = sharded.route_keys(ss.boundaries, q)
    out = np.empty(q.shape, np.int64)
    for d in np.unique(sid):
        mask = sid == d
        local = np.asarray(answer(ss.handles[d].engine(backend), q[mask]),
                           np.int64)
        out[mask] = np.where(local < 0, -1, local + offsets[d])
    return out


# The backends that answer a +inf query exactly.  A batch of more than 8
# queries meets two faults at +inf, in the shard route as in the view: the
# host window search (numpy, and so the reference's numpy backend) casts
# the infinite prediction to int64, and the fused search counts the
# column's +inf padding in its window (``lookup`` finds it, ``search``
# right counts it).  Elsewhere +inf is left out of the comparisons.
INF_EXACT = {"torch-bisect"}

ROUTED_ANSWERS = {
    "left": lambda e, q: e.search(q, "left"),
    "right": lambda e, q: e.search(q, "right"),
    "lookup": lambda e, q: e.lookup(q),
    "point": lambda e, q: e.point(q).rank,
}


def _edge_queries(svc, rng):
    """Queries at every place a shard edge could go wrong: +-inf, below the
    first cut and past the last key, each cut, between a cut and its
    shard's first key, each shard's last key (duplicate runs end there) and
    either side of it, plus enough keys and gaps for dispatch's card tier."""
    snaps = [h.current() for h in svc.handles]
    column = np.concatenate([s.table.keys for s in snaps])
    cuts = svc.boundaries
    firsts = np.array([s.table.keys[0] if s.n_keys else c
                       for s, c in zip(snaps, cuts)])
    lasts = np.array([s.table.keys[-1] for s in snaps if s.n_keys])
    return np.concatenate([
        [-np.inf, np.inf, -2.0 ** 30, 2.0 ** 40, column[0] - 1,
         column[0] - 0.5, column[-1] + 0.5, column[-1] + 1],
        cuts, cuts - 0.5, cuts + 0.5, (cuts + firsts) / 2, firsts - 0.5,
        lasts, lasts - 0.5, lasts + 0.5,
        column[rng.integers(0, column.size, 300)],
        np.floor(rng.uniform(-3, 2 ** 20 + 3, 100))])


@pytest.mark.parametrize("backend", BACKENDS)
def test_the_view_answers_every_verb_like_the_reference_and_the_shard_route(
        backend):
    """Past one shard every verb answers from one engine over the view: it
    equals the reference's sharded service, ``np.searchsorted`` on the
    merged column and, for the ranks, the shard route it replaces -- with a
    shard whose first key sits above its cut, an empty shard, duplicate runs
    ending at shard edges, then after ``insert_many`` + ``publish`` and
    after a rebalance."""
    keys = _dup_heavy_keys(6000, seed=31)
    ours, ref = _pair(keys, error=32, n_shards=5, buffer_size=8)
    lasts = [h.current().table.keys[-1] for h in ours.handles][:-1]
    assert any(np.count_nonzero(keys == k) > 1 for k in lasts)
    cut = float(ours.boundaries[2])
    for svc in (ours, ref):      # the same direct writes on both services
        svc.writers[2].extract_range(cut, cut + 3000)
        svc.writers[3].extract_range(-np.inf, np.inf)
    assert sorted(ours.publish()) == sorted(ref.publish()) == [2, 3]
    assert ours.handles[3].current().n_keys == 0
    assert ours.handles[2].current().table.keys[0] > cut + 1
    rng = np.random.default_rng(32)
    new = np.concatenate([keys[rng.integers(0, keys.size, 400)],
                          np.floor(rng.uniform(-50, 2 ** 20, 300))])

    def check():
        column = np.concatenate([h.current().table.keys
                                 for h in ours.handles])
        q = _edge_queries(ours, rng)
        exact = (q != np.inf) | (backend in INF_EXACT)
        for got, want in zip(_verbs(ours, q[q != np.inf], backend),
                             _verbs(ref, q[q != np.inf], None)):
            np.testing.assert_array_equal(got, want)
        left, right, hit = _oracle(column, q)
        for name, want in (("left", left), ("right", right),
                           ("lookup", hit), ("point", hit)):
            answer = ROUTED_ANSWERS[name]
            got = (ours.point(q, backend).rank if name == "point" else
                   ours.lookup(q, backend) if name == "lookup" else
                   ours.search(q, name, backend))
            np.testing.assert_array_equal(got[exact], want[exact])
            np.testing.assert_array_equal(
                got[exact], _routed_oracle(ours, q, answer, backend)[exact])

    check()
    ours.insert_many(new)
    _insert((ref,), new)
    assert sorted(ours.publish()) == sorted(ref.publish())
    check()
    assert ours.rebalance(force=True) == ref.rebalance(force=True)
    check()
    assert ours.epochs() == ref.epochs()


def test_a_nine_shard_read_is_one_search_call_and_one_shard_builds_no_view(
        monkeypatch):
    """Each read of a nine-shard service calls the fused search once (one
    launch on the card); a one-shard service answers from shard 0's engine
    and never builds a view table."""
    from repro_torch.kernels import fitting_lookup
    calls = []
    real = fitting_lookup.fitting_search
    monkeypatch.setattr(fitting_lookup, "fitting_search",
                        lambda *a, **kw: calls.append(kw["mode"]) or
                        real(*a, **kw))
    keys = _dup_heavy_keys(9000, seed=33)
    q = _queries(keys, np.random.default_rng(34), 3000)
    nine = ShardedIndexService(keys, error=32, n_shards=9, backend="cuda",
                               engine_opts=ON_CPU, assume_sorted=True)
    for read, mode in ((lambda s: s.search(q, "left"), "search-left"),
                       (lambda s: s.search(q, "right"), "search-right"),
                       (lambda s: s.lookup(q), "lookup")):
        calls.clear()
        np.testing.assert_array_equal(read(nine),
                                      _routed_oracle(nine, q, lambda e, x: (
                                          e.lookup(x) if mode == "lookup" else
                                          e.search(x, mode[7:])), "numpy"))
        assert calls == [mode]
    table = nine._view[2].current().table
    assert isinstance(table, sharded.ViewTable) and len(table.tables) == 9
    assert "host" not in vars(table)     # no host tier asked: no host copy

    def refuse(*args):
        raise AssertionError("a one-shard read built a view table")

    monkeypatch.setattr(sharded.ViewTable, "of", refuse)
    one = IndexService(keys, error=32, engine_opts=ON_CPU, assume_sorted=True)
    calls.clear()
    np.testing.assert_array_equal(one.search(q), np.searchsorted(keys, q))
    one.lookup(q), one.point(q), one.count(q, q + 9), one.range(q[0], q[9])
    assert calls == ["search-left", "lookup", "search-left", "search-right",
                     "search-left", "search-left", "search-right"]
    assert one._view is None


def test_a_publish_rebuilds_the_view_from_the_clean_shards_forms():
    """A publish that dirties one shard uploads that shard alone: the clean
    shards' cached device forms stay the same tensors (``data_ptr``), and
    the next read assembles a new view form from all four."""
    import torch
    cpu = torch.device("cpu")
    keys = _dup_heavy_keys(8000, seed=35)
    svc = ShardedIndexService(keys, error=32, n_shards=4, buffer_size=8,
                              engine_opts=ON_CPU, assume_sorted=True)
    svc.search(keys[:8])

    def forms():
        return [h.current().table._device_cache[cpu] for h in svc.handles]

    before = forms()
    ptrs = [f.keys.data_ptr() for f in before]
    view = svc._view[2].current().table._device_cache[cpu]
    new = np.arange(6) + svc.boundaries[1] + 0.5
    svc.insert_many(new)
    assert list(svc.publish()) == [1]
    merged = np.sort(np.concatenate([keys, new]))
    np.testing.assert_array_equal(svc.search(merged),
                                  np.searchsorted(merged, merged))
    after = forms()
    assert [a is b for a, b in zip(after, before)] == [True, False, True, True]
    assert [f.keys.data_ptr() for f in after][::2] == ptrs[::2]
    assert after[3].keys.data_ptr() == ptrs[3]
    rebuilt = svc._view[2].current().table._device_cache[cpu]
    assert rebuilt is not view
    assert torch.equal(rebuilt.keys, torch.cat([f.keys for f in after]))
    assert torch.equal(rebuilt.base, torch.cat(
        [f.base + int(o) for f, o in zip(after, np.cumsum(
            [0] + [f.keys.numel() for f in after[:-1]]))]))


def test_a_reader_that_pinned_the_old_view_keeps_its_table():
    """A view pinned before a publish still answers from its own table
    after the publish lands; a new read sees the new keys."""
    keys = _dup_heavy_keys(6000, seed=37)
    svc = ShardedIndexService(keys, error=32, n_shards=3, buffer_size=8,
                              engine_opts=ON_CPU, assume_sorted=True)
    old = svc._pin_view("cuda")
    new = np.floor(np.random.default_rng(38).uniform(0, 2 ** 20, 500))
    svc.insert_many(new)
    svc.publish()
    merged = np.sort(np.concatenate([keys, new]))
    q = _queries(merged, np.random.default_rng(39), 600)
    np.testing.assert_array_equal(svc._search_view(old, q, "left"),
                                  np.searchsorted(keys, q, "left"))
    np.testing.assert_array_equal(svc.search(q), np.searchsorted(merged, q))
    assert svc._pin_view("cuda").engine is not old.engine
    np.testing.assert_array_equal(svc._search_view(old, q, "right"),
                                  np.searchsorted(keys, q, "right"))


def test_a_view_past_the_int32_positions_is_refused():
    """The device form's positions are int32: a view of 2^31 keys or more
    is refused before anything is assembled."""
    import torch
    keys = _dup_heavy_keys(2000, seed=40)
    t = sharded.SegmentTable.from_keys(keys, 16, assume_sorted=True)
    view = sharded.ViewTable([t, t], [0, 2 ** 31 - t.n_keys])
    assert view.n_keys == 2 ** 31
    with pytest.raises(ValueError, match="int32"):
        view.assemble(torch.device("cpu"))
    small = sharded.ViewTable([t, t], [0, t.n_keys])
    np.testing.assert_array_equal(small.keys, np.concatenate([keys, keys]))
