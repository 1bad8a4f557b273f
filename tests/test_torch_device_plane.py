"""The port's device-sharded plane (``repro_torch.index.device_plane``) and
``repro_torch.core.distributed`` against the JAX package's and the
``np.searchsorted`` oracle, to tolerance 0 (ranks are integers; every
compare is f32 on both sides).

In process the rows sit on the CPU (``devices=["cpu"] * D``) and the
reference has one JAX device, so it is compared at D = 1; at D = 2 and 8
the port is held to the oracle.  One case runs this file as a script in a
subprocess with ``--xla_force_host_platform_device_count=8`` set before JAX
is imported, and holds the port at D = 8 against the reference's
``DeviceShardedService(device_count=8)`` and its ``sharded_*`` functions on
a directly built ``Mesh`` (``jax.make_mesh`` builds an Explicit-axis mesh
that the reference's a2a refuses under this JAX): ranks, the a2a ``ok`` mask
at slack 0.5 and 8, ``overflow_queries``, and the ``DeviceMetrics`` bytes
and publish counts.  The rows' searches run the fused kernel's plain twin
here; the card runs the kernel (``tests/test_torch_gpu.py``).
"""
import os
import sys

if __name__ == "__main__":      # the subprocess case: 8 JAX host devices
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import dataclasses
import pathlib
import subprocess
import threading

import numpy as np
import pytest

from repro.index import fit as ref_fit
from repro.index.device import DeviceShardedService as RefService
from repro_torch.analysis import sanitizer
from repro_torch.core import distributed
from repro_torch.index import DeviceShardedService, DeviceShardSet, fit
from repro_torch.index.telemetry import (CH_DEVICE_COLLECTIVE,
                                         CH_DEVICE_OVERFLOW,
                                         CH_DEVICE_PUBLISH, DeviceMetrics,
                                         Monitor, ServiceMetrics)
from repro_torch.serve import DeviceShardedService as ServedService

ROOT = pathlib.Path(__file__).resolve().parents[1]
ERROR = 64
ROW_FIELDS = ("d_seg_start", "d_slope", "d_base", "d_seg_end", "d_keys")


def _data():
    """``tests/_device_check.py``'s inputs: ~300 distinct values over 20k
    keys, so equal runs straddle the row cuts; queries from the column and
    uniform."""
    rng = np.random.default_rng(7)
    keys = np.sort(rng.choice(rng.integers(0, 1 << 20, 300), 20_000))
    keys = keys.astype(np.float64)
    queries = np.concatenate([keys[::11],
                              rng.integers(0, 1 << 20, 500).astype(np.float64)])
    return keys, queries


def _oracle(keys, q, side):
    return np.searchsorted(keys.astype(np.float32),
                           np.asarray(q, np.float64).astype(np.float32), side)


def _check_verbs(svc, keys, queries, what):
    """Every verb equals the f32 oracle."""
    left, right = _oracle(keys, queries, "left"), _oracle(keys, queries,
                                                          "right")
    for side, want in (("left", left), ("right", right)):
        np.testing.assert_array_equal(svc.search(queries, side), want,
                                      err_msg=f"{what}/search/{side}")
    found = right > left
    np.testing.assert_array_equal(svc.lookup(queries),
                                  np.where(found, left, -1), err_msg=what)
    pt = svc.point(queries)
    np.testing.assert_array_equal(pt.rank, np.where(found, left, -1))
    np.testing.assert_array_equal(pt.found, found)
    pred = svc.predecessor(queries)
    np.testing.assert_array_equal(pred.rank, np.where(right > 0, right - 1,
                                                      -1))
    succ = svc.successor(queries)
    np.testing.assert_array_equal(succ.rank,
                                  np.where(left < keys.size, left, -1))
    lo, hi = queries - 5.0, queries + 5.0
    np.testing.assert_array_equal(
        svc.count(lo, hi),
        np.maximum(_oracle(keys, hi, "right") - _oracle(keys, lo, "left"), 0))
    rr = svc.range(float(keys[100]), float(keys[15_000]))
    lo_r = int(_oracle(keys, keys[100:101], "left")[0])
    hi_r = int(_oracle(keys, keys[15_000:15_001], "right")[0])
    assert (rr.lo_rank, rr.hi_rank) == (lo_r, hi_r), what
    np.testing.assert_array_equal(rr.keys, keys[lo_r:hi_r])


def _answers(svc, queries):
    """Every verb's answer, for comparing two services."""
    out = [svc.search(queries, "left"), svc.search(queries, "right"),
           svc.lookup(queries), svc.count(queries - 5.0, queries + 5.0)]
    for res in (svc.point(queries), svc.predecessor(queries),
                svc.successor(queries)):
        out += [res.rank, res.found]
    rr = svc.range(float(queries[3]), float(queries[-3]))
    return out + [np.asarray([rr.lo_rank, rr.hi_rank]), rr.keys]


def _metrics(svc) -> DeviceMetrics:
    """The device node without its wall clock (the one field two runs do
    not share)."""
    dm = svc.metrics().device
    return dataclasses.replace(dm, collective_wall_ns=0.0)


def _same_metrics(ours, theirs):
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def _service(keys, d, **kw):
    kw.setdefault("assume_sorted", True)
    return DeviceShardedService(keys, error=ERROR, device_count=d,
                                devices=["cpu"] * d, **kw)


@pytest.fixture(scope="module")
def data():
    return _data()


# ------------------------------------------------------------- in process
@pytest.mark.parametrize("exchange", ["allgather", "a2a", "auto"])
@pytest.mark.parametrize("d", [1, 2, 8])
def test_every_verb_equals_the_oracle(data, d, exchange):
    keys, queries = data
    svc = _service(keys, d, buffer_size=16, exchange=exchange)
    assert svc.n_devices == d and svc.exchange == exchange
    _check_verbs(svc, keys, queries, f"D={d}/{exchange}")
    dm = svc.metrics().device
    assert dm.n_devices == d and dm.exchange == exchange
    assert dm.allgather_calls + dm.a2a_calls > 0
    if d > 1 and exchange == "a2a":
        assert dm.a2a_calls > 0


def test_one_row_equals_the_reference(data):
    """At D = 1 the port and the reference's in-process plane give the same
    answers and the same device counters through a build, reads, a delta
    publish, a rebalance and a plan swap."""
    keys, queries = data
    ours = _service(keys, 1, buffer_size=16, exchange="a2a")
    theirs = RefService(keys, error=ERROR, device_count=1, buffer_size=16,
                        exchange="a2a", assume_sorted=True)
    for a, b in zip(_answers(ours, queries), _answers(theirs, queries)):
        np.testing.assert_array_equal(a, b)
    _same_metrics(_metrics(ours), _metrics(theirs))
    for k in (float(keys[500]) + 0.5, float(keys[-1]) + 3.0):
        ours.insert(k)
        theirs.insert(k)
    assert ours.publish().keys() == theirs.publish().keys()
    assert ours.rebalance(force=True) == theirs.rebalance(force=True)
    plan_ours = ours.apply_plan(ours.plan.replace(error=32, buffer_size=8))
    plan_theirs = theirs.apply_plan(theirs.plan.replace(error=32,
                                                        buffer_size=8))
    assert (plan_ours.error, plan_ours.device_count, plan_ours.exchange) == \
        (plan_theirs.error, plan_theirs.device_count, plan_theirs.exchange)
    for a, b in zip(_answers(ours, queries), _answers(theirs, queries)):
        np.testing.assert_array_equal(a, b)
    _same_metrics(_metrics(ours), _metrics(theirs))
    assert ours.metrics().query_counts == theirs.metrics().query_counts
    m = ours.metrics()
    assert m.service == "device" and ServiceMetrics.from_json(m.to_json()) == m
    with pytest.warns(DeprecationWarning):
        ours.stats()


def test_a2a_skew_overflow_is_answered_exactly(data):
    """Every query owned by row 0 at slack 1: the answers stay exact (the
    follow-up allgather pass) and only the telemetry sees the overflow."""
    keys, _ = data
    mon = Monitor()
    svc = _service(keys, 8, exchange="a2a", slack=1.0, monitor=mon)
    skew = np.full(512, float(keys[0]))
    np.testing.assert_array_equal(svc.search(skew), _oracle(keys, skew,
                                                            "left"))
    left, right = _oracle(keys, skew, "left"), _oracle(keys, skew, "right")
    np.testing.assert_array_equal(svc.lookup(skew),
                                  np.where(right > left, left, -1))
    dm = svc.metrics().device
    # 512 queries in 8 chunks of 64, each bucket holds ceil(64/8) = 8, and
    # an overflowing bucket keeps 7 (its last slot goes to a sentinel)
    assert dm.a2a_overflow_queries == 3 * 8 * (64 - 7)
    assert mon.count(CH_DEVICE_OVERFLOW) == 3
    assert mon.count(CH_DEVICE_COLLECTIVE) == 3
    assert mon.count(CH_DEVICE_PUBLISH) == 1


def test_one_row_publish_keeps_the_clean_rows(data):
    """A publish that dirties one shard re-uploads that row's five tensors
    and its live count, keeps the clean rows' storage, and uploads
    ``row_bytes * 1 + replicated_bytes * D``."""
    keys, _ = data
    svc = _service(keys, 8, buffer_size=16)
    ds0 = svc.device_set
    assert isinstance(ds0, DeviceShardSet) and ds0.n_devices == 8
    ptr0 = {f: [t.data_ptr() for t in getattr(ds0, f)] for f in ROW_FIELDS}
    target = float(keys[0]) + 0.25
    dirty = svc.shard_of(target)
    before = svc.metrics().device
    svc.insert(target)
    svc.publish()
    ds1 = svc.device_set
    assert ds1.version == ds0.version + 1
    assert (ds1.s_cap, ds1.m_cap) == (ds0.s_cap, ds0.m_cap)
    for f, was in ptr0.items():
        now = [t.data_ptr() for t in getattr(ds1, f)]
        assert [a != b for a, b in zip(now, was)] == \
            [r == dirty for r in range(8)], f
    assert ds1.n_local == tuple(n + (r == dirty)
                                for r, n in enumerate(ds0.n_local))
    after = svc.metrics().device
    assert after.delta_publishes == before.delta_publishes + 1
    assert after.full_publishes == before.full_publishes == 1
    up = after.bytes_uploaded - before.bytes_uploaded
    assert up == ds1.row_bytes() + ds1.replicated_bytes() * 8
    full = after.bytes_full_equivalent - before.bytes_full_equivalent
    assert full == (ds1.row_bytes() + ds1.replicated_bytes()) * 8
    assert up * 4 < full
    merged = np.sort(np.append(keys, target))
    assert int(svc.search(np.asarray([target]))[0]) == \
        int(_oracle(merged, [target], "left")[0])
    assert svc.rebalance(force=True) is not None
    assert svc.metrics().device.full_publishes == 2
    assert all(a.data_ptr() != b.data_ptr() for a, b in
               zip(svc.device_set.d_keys, ds1.d_keys))


@pytest.fixture
def sanitize_on():
    prev = sanitizer.set_enabled(True)
    try:
        yield
    finally:
        sanitizer.set_enabled(prev)


def test_publisher_races_readers_under_the_sanitizer(data, sanitize_on):
    """Readers pin one manifest per verb while a writer publishes 40 epochs
    into the last row: every answer fits some published key set, and the
    pin tracker and the lock-order watchdog stay quiet."""
    keys, _ = data
    svc = _service(keys, 8, buffer_size=16, exchange="allgather")
    # probe[1] lies past all 40 inserts, so it is absent in every epoch
    probe = np.asarray([float(keys[0]), float(keys[-1]) + 100.0])
    stop = threading.Event()
    errors, inserted = [], []

    def writer():
        try:
            for i in range(1, 41):
                svc.insert(float(keys[-1]) + i)
                inserted.append(float(keys[-1]) + i)
                svc.publish()
        except BaseException as exc:  # noqa: BLE001 - surfaced below
            errors.append(exc)
        finally:
            stop.set()

    def reader():
        try:
            while not stop.is_set():
                r = svc.point(probe)
                assert int(r.rank[0]) == 0 and bool(r.found[0])
                assert not bool(r.found[1])
                n = int(svc.search(probe[1:])[0])
                assert keys.size <= n <= keys.size + 40
        except BaseException as exc:  # noqa: BLE001
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=writer)] + \
            [threading.Thread(target=reader) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    final = np.sort(np.concatenate([keys, inserted]))
    np.testing.assert_array_equal(svc.search(final[::97]),
                                  _oracle(final, final[::97], "left"))
    assert svc.metrics().device.publishes == 41


def test_open_index_serves_a_device_plan(data):
    """A ``FitSpec(device_count=...)`` plan opens the port's service on the
    rows ``devices`` names; without ``devices`` and without the cards it
    raises rather than fall back to the CPU."""
    keys, queries = data
    spec = dict(error=ERROR, device_count=4, batch_sizes=(256, 1 << 16),
                insert_rate=100.0)
    p = fit.plan(keys, fit.FitSpec(**spec))
    ref_p = ref_fit.plan(keys, ref_fit.FitSpec(**spec))
    assert p.backend == ref_p.backend == "device"
    assert (p.device_count, p.n_shards) == (ref_p.device_count,
                                            ref_p.n_shards) == (4, 4)
    svc = fit.open_index(keys, p, devices=["cpu"] * 4)
    assert isinstance(svc, ServedService) and svc.plan is p
    assert [str(x) for x in svc.devices] == ["cpu"] * 4
    for side in ("left", "right"):
        np.testing.assert_array_equal(svc.search(queries, side),
                                      _oracle(keys, queries, side))
    with pytest.raises(ValueError, match=r"exceeds .* devices=\["):
        fit.open_index(keys, p)


def test_validation_matches_the_reference(data):
    keys, _ = data
    with pytest.raises(ValueError, match="backend='device'"):
        DeviceShardedService(keys, plan=fit.IndexPlan.from_knobs(error=16),
                             devices=["cpu"])
    with pytest.raises(TypeError, match="not both"):
        DeviceShardedService(
            keys, error=16, devices=["cpu"],
            plan=fit.plan(keys, fit.FitSpec(error=16, device_count=1)))
    with pytest.raises(ValueError, match="exceeds"):
        DeviceShardedService(keys, error=16, device_count=10_000)
    with pytest.raises(ValueError, match="exchange"):
        _service(keys, 2, exchange="bogus")
    with pytest.raises(ValueError, match="rows"):
        DeviceShardedService(keys, error=16, device_count=2,
                             devices=["cpu"] * 3)


def test_distributed_wrappers_match_the_oracle():
    """``repro_torch.core.distributed`` on ``tests/_distributed_check.py``'s
    inputs at D = 8 CPU rows: allgather and a2a at slack 8 exact, and at
    slack 0.5 on a stream owned by row 0 the flagged drops are the only
    misses."""
    cpu8 = ["cpu"] * 8
    q, keys, want, skew = _distributed_inputs()
    si = distributed.build_sharded_index(keys, error=ERROR, n_shards=8,
                                         devices=cpu8)
    np.testing.assert_array_equal(
        distributed.lookup_allgather(si, q, cpu8).numpy(), want)
    got, ok = distributed.lookup_a2a(si, q, cpu8, slack=8.0)
    assert bool(ok.all())
    np.testing.assert_array_equal(got.numpy(), want)
    got, ok = distributed.lookup_a2a(si, skew, cpu8, slack=0.5)
    got, ok = got.numpy(), ok.numpy()
    exp = np.searchsorted(keys.astype(np.float32), skew, "left")
    assert 0 < int((~ok).sum()) < skew.size
    np.testing.assert_array_equal(got[ok], exp[ok])


def _distributed_inputs():
    rng = np.random.default_rng(0)
    keys = np.sort(rng.choice(2 ** 22, size=80_000,
                              replace=False)).astype(np.float64)
    q_present = keys[rng.integers(0, keys.shape[0], size=192)]
    queries = np.concatenate([q_present, q_present[:64] + 0.5])
    rng.shuffle(queries)
    q = queries.astype(np.float32)
    k32 = keys.astype(np.float32)
    want = np.searchsorted(k32, q, "left")
    present = k32[np.minimum(want, keys.shape[0] - 1)] == q
    skew = np.sort(keys[:256]).astype(np.float32)
    return q, keys, np.where(present, want, -1), skew


# ------------------------------------------------- D = 8 against the reference
def test_port_equals_the_reference_at_8_devices():
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu", "REPRO_SANITIZE": "1"}
    res = subprocess.run([sys.executable, __file__], capture_output=True,
                         text=True, timeout=300, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stdout + "\n" + res.stderr
    assert "ALL_OK" in res.stdout


def _main() -> None:
    from functools import partial

    import jax
    import torch
    from jax.sharding import Mesh

    from repro.core import distributed as ref_dist
    from repro.index import device as ref_device
    from repro_torch.index import device_plane

    assert jax.device_count() == 8
    torch.set_num_threads(2)
    keys, queries = _data()
    cpu8 = ["cpu"] * 8
    mesh = Mesh(np.asarray(jax.devices()[:8]), ("data",))

    # the service, both exchanges: answers, then one delta publish and a
    # rebalance, with every device counter equal after each
    for xchg in ("allgather", "a2a"):
        ours = _service(keys, 8, buffer_size=16, exchange=xchg)
        theirs = RefService(keys, error=ERROR, device_count=8,
                            buffer_size=16, exchange=xchg,
                            assume_sorted=True)
        for a, b in zip(_answers(ours, queries), _answers(theirs, queries)):
            np.testing.assert_array_equal(a, b, err_msg=xchg)
        _same_metrics(_metrics(ours), _metrics(theirs))
        for svc in (ours, theirs):
            svc.insert(float(keys[0]) + 0.25)
            svc.publish()
        _same_metrics(_metrics(ours), _metrics(theirs))
        assert ours.rebalance(force=True) == theirs.rebalance(force=True)
        np.testing.assert_array_equal(ours.search(queries),
                                      theirs.search(queries))
        _same_metrics(_metrics(ours), _metrics(theirs))
        print(f"{xchg}: every verb and DeviceMetrics equal the reference")

    # a2a overflow at slack 1 on a stream owned by row 0: the same count
    skew = np.full(512, float(keys[0]))
    ours = _service(keys, 8, exchange="a2a", slack=1.0)
    theirs = RefService(keys, error=ERROR, device_count=8, exchange="a2a",
                        slack=1.0, assume_sorted=True)
    np.testing.assert_array_equal(ours.lookup(skew), theirs.lookup(skew))
    assert ours.metrics().device.a2a_overflow_queries == \
        theirs.metrics().device.a2a_overflow_queries > 0
    print("a2a overflow_queries equal the reference")

    # the sharded searches on the two manifests: ranks and the ok mask
    ds, rs = ours.device_set, theirs.device_set
    q = np.resize(np.concatenate([queries, skew]), 8 * 384).astype(np.float32)
    for slack in (0.5, 8.0):
        for side in ("left", "right"):
            fn = jax.jit(partial(ref_device.sharded_search_a2a, mesh=mesh,
                                 error=ERROR, side=side, slack=slack))
            r_ref, ok_ref = fn(rs.d_seg_start, rs.d_slope, rs.d_base,
                               rs.d_seg_end, rs.d_keys, rs.d_n_local,
                               rs.d_offsets, rs.d_boundaries, q)
            r, ok = device_plane.sharded_search_a2a(
                ds.d_seg_start, ds.d_slope, ds.d_base, ds.d_seg_end,
                ds.d_keys, ds.n_local, ds.d_offsets, ds.d_boundaries,
                torch.from_numpy(q), devices=cpu8, error=ERROR, side=side,
                slack=slack, n_segments=ds.n_seg_local)
            np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_ref))
            np.testing.assert_array_equal(r.numpy(), np.asarray(r_ref))
            print(f"a2a slack {slack} {side}: ranks and ok equal "
                  f"({int((~ok).sum())} drops)")
    fn = jax.jit(partial(ref_device.sharded_search_allgather, mesh=mesh,
                         error=ERROR, side="right"))
    r_ref = fn(rs.d_seg_start, rs.d_slope, rs.d_base, rs.d_seg_end,
               rs.d_keys, rs.d_n_local, q)
    r = device_plane.sharded_search_allgather(
        ds.d_seg_start, ds.d_slope, ds.d_base, ds.d_seg_end, ds.d_keys,
        ds.n_local, torch.from_numpy(q), devices=cpu8, error=ERROR,
        side="right", n_segments=ds.n_seg_local)
    np.testing.assert_array_equal(r.numpy(), np.asarray(r_ref))
    print("sharded_search_a2a and sharded_search_allgather equal the "
          "reference")

    # the same device plan through both open_index
    spec = dict(error=ERROR, device_count=8, batch_sizes=(1 << 16,))
    ours = fit.open_index(keys, fit.plan(keys, fit.FitSpec(**spec)),
                          devices=cpu8)
    theirs = ref_fit.open_index(keys, ref_fit.plan(keys,
                                                   ref_fit.FitSpec(**spec)))
    assert ours.exchange == theirs.exchange
    for side in ("left", "right"):
        np.testing.assert_array_equal(ours.search(queries, side),
                                      theirs.search(queries, side))
    print("open_index of one device plan equal")

    # core/distributed on _distributed_check.py's inputs
    qd, dkeys, want, dskew = _distributed_inputs()
    si = distributed.build_sharded_index(dkeys, error=ERROR, n_shards=8,
                                         devices=cpu8)
    ref_si = ref_dist.build_sharded_index(dkeys, error=ERROR, n_shards=8,
                                          mesh=mesh, axis="data")
    got = distributed.lookup_allgather(si, qd, cpu8).numpy()
    ref = jax.jit(lambda x: ref_dist.lookup_allgather(ref_si, x, mesh))(qd)
    np.testing.assert_array_equal(got, np.asarray(ref))
    np.testing.assert_array_equal(got, want)
    for x, slack in ((qd, 8.0), (dskew, 0.5)):
        got, ok = distributed.lookup_a2a(si, x, cpu8, slack=slack)
        ref, ok_ref = jax.jit(lambda y, s=slack: ref_dist.lookup_a2a(
            ref_si, y, mesh, slack=s))(x)
        np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_ref))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    print("core/distributed equals the reference and the oracle")
    print("ALL_OK")


if __name__ == "__main__":
    _main()
