"""The port's FITingTree (``repro_torch.core.tree``) against the JAX
package's, and the port's SnapshotPublisher over it.

Both trees are host numpy code: on the same keys, inserts and calls they must
hold the same segments (start keys, slopes), pages, buffers and payloads and
give the same answers, to tolerance 0.  Inputs are those of
``tests/test_tree.py`` (uniform floats, ``iot_like``, ``step_data``) with
fixed seeds.
"""
import numpy as np
import pytest
import torch

from _cone_cases import MODES, cone_cases, weblogs_tree
from repro.core.datasets import iot_like, step_data
from repro.core.tree import FITingTree as RefTree
from repro.core.tree import PackedRouter as RefRouter
from repro_torch.core.segmentation import shrinking_cone, shrinking_cone_py
from repro_torch.core.tree import FITingTree, PackedRouter
from repro_torch.index import ServingHandle, SnapshotPublisher
from repro_torch.kernels.shrinking_cone import (shrinking_cone_runs,
                                                shrinking_cone_runs_cuda)


def _uniform(n=5000, seed=0):
    return np.sort(np.random.default_rng(seed).uniform(0, 1e7, size=n))


DATA = {
    "uniform": lambda: _uniform(),
    "iot_like": lambda: iot_like(20_000, seed=1),
    "step_data": lambda: step_data(n=20_000, step=100),
}


def _assert_same(ours, ref):
    np.testing.assert_array_equal(ours.start_keys, ref.start_keys)
    np.testing.assert_array_equal(ours.slopes, ref.slopes)
    assert len(ours.pages) == len(ref.pages)
    for a, b in zip(ours.pages, ref.pages):
        np.testing.assert_array_equal(a, b)
    assert ours.buffers == ref.buffers
    assert ours.buf_payloads == ref.buf_payloads
    if ref.payloads is None:
        assert ours.payloads is None
    else:
        for a, b in zip(ours.payloads, ref.payloads):
            np.testing.assert_array_equal(a, b)
    assert (ours.n_keys, ours.n_segments, ours.err_seg) == \
        (ref.n_keys, ref.n_segments, ref.err_seg)
    assert ours.index_size_bytes() == ref.index_size_bytes()
    assert ours.max_abs_error() == ref.max_abs_error()
    t, r = ours.as_table(epoch=3), ref.as_table(epoch=3)
    for f in ("start_key", "slope", "base", "seg_end", "keys"):
        np.testing.assert_array_equal(getattr(t, f), getattr(r, f))
    assert (t.error, t.epoch) == (r.error, r.epoch)


def _pair(keys, **kw):
    return FITingTree(keys, **kw), RefTree(keys, **kw)


@pytest.mark.parametrize("error,buffer_size", [(16, 0), (64, 16)])
@pytest.mark.parametrize("name", sorted(DATA))
def test_build_gives_the_reference_tree(name, error, buffer_size):
    ours, ref = _pair(DATA[name](), error=error, buffer_size=buffer_size)
    _assert_same(ours, ref)


@pytest.mark.parametrize("name", sorted(DATA))
def test_inserts_and_flush_give_the_reference_tree(name):
    """Alg. 4: the same inserts overflow the same buffers, re-segment the
    same runs; flush re-fits the same dirty segments."""
    keys = DATA[name]()
    ours, ref = _pair(keys, error=64, buffer_size=16)
    rng = np.random.default_rng(2)
    new = np.concatenate([rng.uniform(keys[0], keys[-1], 1500),
                          keys[rng.integers(0, keys.shape[0], 500)]])
    for i, k in enumerate(new):
        ours.insert(float(k))
        ref.insert(float(k))
        if i % 500 == 499:
            _assert_same(ours, ref)
    assert ours.dirty_segments() == ref.dirty_segments()
    assert ours.flush() == ref.flush()
    _assert_same(ours, ref)
    assert ours.flush() == ref.flush() == 0


def test_insert_burst_splits_the_same_segments():
    keys = np.arange(1000, dtype=np.float64)
    ours, ref = _pair(keys, error=64, buffer_size=8)
    for i in range(64):
        ours.insert(500.0 + i * 1e-4)
        ref.insert(500.0 + i * 1e-4)
    _assert_same(ours, ref)


@pytest.mark.parametrize("name", sorted(DATA))
def test_lookups_and_range_queries_equal(name):
    keys = DATA[name]()
    ours, ref = _pair(keys, error=32, buffer_size=8)
    rng = np.random.default_rng(3)
    for k in rng.uniform(keys[0], keys[-1], 300):
        ours.insert(float(k))
        ref.insert(float(k))
    q = np.concatenate([keys[::37], rng.uniform(keys[0], keys[-1], 200)])
    np.testing.assert_array_equal(ours.lookup_batch(q), ref.lookup_batch(q))
    assert [ours.lookup(float(k)) for k in q[::7]] == \
        [ref.lookup(float(k)) for k in q[::7]]
    for lo, hi in ((keys[100], keys[1500]), (keys[0], keys[-1]),
                   (keys[50], keys[40]), (keys[-1] + 1, keys[-1] + 2)):
        np.testing.assert_array_equal(ours.range_query(lo, hi),
                                      ref.range_query(lo, hi))


def test_extract_range_and_splice_run_equal_with_payloads():
    """The rebalance migration path: same keys and payloads out, same
    segments left behind, same result after splicing them into another
    tree; extracting everything leaves the same empty tree."""
    keys = np.floor(iot_like(8000, seed=4) * 1e3)
    pl = np.arange(keys.shape[0]) * 10
    ours, ref = _pair(keys, error=32, buffer_size=8, payload=pl)
    for k in keys[::53] + 0.5:
        ours.insert(float(k), -1)
        ref.insert(float(k), -1)
    lo, hi = keys[2000], keys[5000]
    got, want = ours.extract_range(lo, hi), ref.extract_range(lo, hi)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    _assert_same(ours, ref)
    other = keys[::3] + 0.25
    dst, dst_ref = _pair(other, error=32, payload=np.zeros(other.shape[0]))
    dst.splice_run(got[0], got[1])
    dst_ref.splice_run(want[0], want[1])
    _assert_same(dst, dst_ref)
    got, want = (ours.extract_range(-np.inf, np.inf),
                 ref.extract_range(-np.inf, np.inf))
    np.testing.assert_array_equal(got[0], want[0])
    _assert_same(ours, ref)
    ours.splice_run(got[0], got[1])
    ref.splice_run(want[0], want[1])
    _assert_same(ours, ref)


def test_packed_router_descends_like_the_reference():
    keys = _uniform(50_000)
    ours, ref = _pair(keys, error=16)
    q = np.sort(np.random.default_rng(3).uniform(0, 1e7, size=500))
    np.testing.assert_array_equal(ours.router.descend(q),
                                  ref.router.descend(q))
    r, rr = (PackedRouter(np.arange(16 ** 3, dtype=np.float64)),
             RefRouter(np.arange(16 ** 3, dtype=np.float64)))
    assert (r.height, r.size_bytes()) == (rr.height, rr.size_bytes())


def test_publisher_round_trip_over_the_ported_tree():
    """insert -> publish -> serve (tests/test_index_core.py's round trip):
    the published table is the reference publisher's, every backend of the
    port answers np.searchsorted, and the retired epoch keeps serving."""
    from repro.index import SnapshotPublisher as RefPublisher
    rng = np.random.default_rng(2)
    keys = np.sort(rng.choice(2 ** 23, size=4000,
                              replace=False)).astype(np.float64)
    fresh = np.setdiff1d(rng.choice(2 ** 23, size=2000, replace=False)
                         .astype(np.float64), keys)
    new = fresh[:600]
    ours, ref = _pair(keys, error=64, buffer_size=16)
    pub, ref_pub = SnapshotPublisher(ours), RefPublisher(ref)
    cpu = {"device": "cpu"}
    handle = ServingHandle(engine_opts={"cuda": cpu, "torch-bisect": cpu,
                                        "torch-window": cpu})
    handle.install(pub.publish())
    ref_pub.publish()
    old = handle.current()
    for k in new:
        ours.insert(float(k))
        ref.insert(float(k))
    assert pub.dirty_segments() == ref_pub.dirty_segments()
    q = np.concatenate([new[::5], keys[::97], fresh[600:700]])
    assert np.all(handle.lookup(new[::5]) == -1)          # not yet visible
    snap, ref_snap = pub.publish(), ref_pub.publish()
    assert (snap.epoch, snap.n_refit) == (ref_snap.epoch, ref_snap.n_refit)
    np.testing.assert_array_equal(snap.table.keys, ref_snap.table.keys)
    np.testing.assert_array_equal(snap.table.start_key,
                                  ref_snap.table.start_key)
    assert not pub.dirty_segments()
    handle.install(snap)
    union = np.sort(np.concatenate([keys, new]))
    left = np.searchsorted(union, q)
    hit = union[np.minimum(left, union.shape[0] - 1)] == q
    for backend in ("numpy", "torch-window", "torch-bisect", "cuda"):
        np.testing.assert_array_equal(handle.lookup(q, backend),
                                      np.where(hit, left, -1))
    assert handle.epoch == 2
    old_handle = ServingHandle(engine_opts={"cuda": cpu})
    old_handle.install(old)
    assert np.all(old_handle.lookup(new[:20]) == -1)


def _insert_stream(keys, n, seed, below=False):
    """Inserts drawn from a seed: copies of column keys, uniform floats over
    the column's range and (``below``) keys under its first key."""
    rng = np.random.default_rng(seed)
    new = [keys[rng.integers(0, keys.shape[0], n // 2)],
           rng.uniform(keys[0], keys[-1], n - n // 2)]
    if below:
        new.append(keys[0] - rng.uniform(1, 1e3, 40))
    out = np.concatenate(new)
    rng.shuffle(out)
    return out


# (name, buffer_size, payload, below the first key, batch sizes)
INSERT_MANY_CASES = [
    ("uniform", 16, False, False, (1, 7, 300)),
    ("uniform", 16, True, False, (64, 500)),
    ("iot_like", 4, False, False, (2000,)),          # overflows mid-batch
    ("iot_like", 4, True, True, (1500, 1)),
    ("step_data", 8, False, True, (800, 800)),
    ("step_data", 8, True, False, (3000,)),
]


@pytest.mark.parametrize("name,buffer_size,payload,below,batches",
                         INSERT_MANY_CASES)
def test_insert_many_leaves_the_per_key_loops_tree(name, buffer_size,
                                                   payload, below, batches):
    """``insert_many`` equals ``insert`` key by key, field by field: pages,
    buffers, payloads, start keys, slopes, the router's leaves and the
    dirty segments, after each batch and after a flush; and the JAX
    package's per-key ``insert`` gives the same tree."""
    keys = DATA[name]()
    pl = np.arange(keys.shape[0]) * 10 if payload else None
    kw = dict(error=64 if buffer_size == 16 else 32, buffer_size=buffer_size,
              payload=pl)
    loop, ref = _pair(keys, **kw)
    batch = FITingTree(keys, **kw)
    new = _insert_stream(keys, sum(batches), seed=len(batches), below=below)
    vals = -np.arange(new.shape[0]) - 1 if payload else None
    a = 0
    for size in batches:
        part = new[a:a + size]
        pv = None if vals is None else vals[a:a + size]
        for i, k in enumerate(part):
            v = None if pv is None else int(pv[i])
            loop.insert(float(k), v)
            ref.insert(float(k), v)
        batch.insert_many(part, None if pv is None else pv.tolist())
        a += size
        for tree in (batch, ref):
            _assert_same(tree, loop)
        assert batch.dirty_segments() == loop.dirty_segments()
        np.testing.assert_array_equal(batch.router.levels[-1],
                                      loop.router.levels[-1])
        assert batch.router.height == loop.router.height
    # some buffer overflowed mid-batch: merged keys sit in pages
    assert sum(p.shape[0] for p in batch.pages) > keys.shape[0]
    assert batch.flush() == loop.flush() == ref.flush()
    _assert_same(batch, loop)
    _assert_same(ref, loop)


def test_insert_many_refuses_what_insert_refuses():
    keys = _uniform(500)
    with pytest.raises(ValueError, match="read-only"):
        FITingTree(keys, error=16).insert_many(keys[:3])
    tree = FITingTree(keys, error=16, buffer_size=4)
    with pytest.raises(ValueError, match="values"):
        tree.insert_many(keys[:3], [1, 2])
    tree.insert_many(np.empty(0))
    assert not tree.dirty_segments()


# ------------------------------------------- the batched flush and its fit
CONE_CASES = cone_cases()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", sorted(CONE_CASES))
def test_run_fitter_twin_is_shrinking_cone_run_by_run(case, mode):
    """The host path of ``shrinking_cone_runs`` flags each run's
    ``shrinking_cone`` starts (and, clamped, gives its slopes) bit for bit;
    the readable Alg. 2 finds the same starts."""
    keys, off, error = CONE_CASES[case]
    is_start, slope = shrinking_cone_runs(torch.from_numpy(keys), off, error,
                                          mode)
    assert is_start.dtype == torch.uint8 and is_start.shape == keys.shape
    assert (slope is None) == (mode == "paper")
    for a, b in zip(off[:-1].tolist(), off[1:].tolist()):
        segs = shrinking_cone(keys[a:b], error, mode=mode)
        np.testing.assert_array_equal(
            np.flatnonzero(is_start[a:b].numpy()), segs.base)
        if slope is not None:
            np.testing.assert_array_equal(slope[a:b].numpy()[segs.base],
                                          segs.slope)
        if b - a <= 1000:
            np.testing.assert_array_equal(
                shrinking_cone_py(keys[a:b], error, mode=mode).base,
                segs.base)


def test_run_fitter_refuses_what_its_kernel_cannot_take():
    keys = torch.arange(10, dtype=torch.float64)
    for off in ([0, 5], [1, 10], [0, 5, 5, 10], [[0, 10]], [0.0, 10.0]):
        with pytest.raises(ValueError, match="offsets"):
            shrinking_cone_runs(keys, np.asarray(off), 4)
    with pytest.raises(ValueError, match="float64"):
        shrinking_cone_runs(keys.float(), [0, 10], 4)
    with pytest.raises(ValueError, match="mode"):
        shrinking_cone_runs(keys, [0, 10], 4, "greedy")
    with pytest.raises(ValueError, match="CUDA"):
        shrinking_cone_runs_cuda(keys, [0, 10], 4)
    with pytest.raises(ValueError, match="no shrinking_cone kernel"):
        shrinking_cone_runs(keys.to("meta"), [0, 10], 4)


def _straddling_keys():
    """Duplicate runs of up to 120 keys: at error 32 segments start and end
    inside them, so equal keys sit on both sides of a boundary."""
    rng = np.random.default_rng(11)
    return np.repeat(np.arange(0.0, 3000.0, 10.0),
                     rng.integers(1, 120, 300))


def _flush_inserts(scenario, tree):
    """Keys (one batch) that leave the scenario's dirty segments."""
    rng = np.random.default_rng(5)
    keys = tree.as_table().keys
    if scenario == "one dirty segment":
        page = tree.pages[tree.n_segments // 2]
        return page[[0, page.shape[0] // 2, -1]] + 0.25
    if scenario == "every segment dirty":
        return tree.start_keys.copy()
    if scenario == "straddling duplicates":
        return np.concatenate([tree.start_keys,
                               keys[rng.integers(0, keys.shape[0], 300)]])
    # below the first start key, and in every other segment
    return np.concatenate([keys[0] - rng.uniform(1, 50, 3),
                           tree.start_keys[1::2] + 0.25])


FLUSH_SCENARIOS = ("one dirty segment", "every segment dirty",
                   "straddling duplicates", "below the first key")


@pytest.mark.parametrize("payload", [False, True])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("scenario", FLUSH_SCENARIOS)
def test_batched_flush_gives_the_reference_tree(scenario, mode, payload):
    """One merge and one fit over every dirty run leave the JAX package's
    per-segment flush: pages, payload pages, start keys, slopes, buffers,
    the return value and ``as_table()``."""
    keys = (_straddling_keys() if scenario == "straddling duplicates"
            else _uniform(4000, seed=3))
    pl = np.arange(keys.shape[0]) * 10 if payload else None
    kw = dict(error=32, buffer_size=8, mode=mode, payload=pl)
    ours, ref = _pair(keys, **kw)
    new = _flush_inserts(scenario, ours)
    vals = -np.arange(new.shape[0]) - 1 if payload else None
    ours.insert_many(new, None if vals is None else vals.tolist())
    for i, k in enumerate(new):
        ref.insert(float(k), None if vals is None else int(vals[i]))
    _assert_same(ours, ref)
    dirty = ours.dirty_segments()
    if scenario == "one dirty segment":
        assert len(dirty) == 1
    if scenario == "every segment dirty":
        assert len(dirty) == ours.n_segments
    if scenario == "below the first key":
        assert dirty[0] == 0 and min(ours.buffers[0]) < ours.start_keys[0]
    assert ours.flush() == ref.flush() == len(dirty)
    _assert_same(ours, ref)
    assert ours.flush() == ref.flush() == 0


@pytest.mark.parametrize("mode", MODES)
def test_batched_flush_on_a_weblogs_shard_gives_the_reference_tree(mode):
    """A Weblogs-shaped shard through three publishes of spread inserts."""
    ours = weblogs_tree(2 ** 15, 0, seed=2, mode=mode)
    ref = RefTree(ours.as_table().keys, error=64, buffer_size=16, mode=mode,
                  assume_sorted=True)
    rng = np.random.default_rng(8)
    for _ in range(3):
        keys = ours.as_table().keys
        new = np.concatenate([keys[rng.integers(0, keys.shape[0], 150)],
                              np.floor(rng.uniform(0, 2 ** 15, 50))])
        ours.insert_many(new)
        for k in new:
            ref.insert(float(k))
        assert len(ours.dirty_segments()) > 20
        assert ours.flush() == ref.flush()
        _assert_same(ours, ref)


@pytest.mark.parametrize("mode", MODES)
def test_extract_range_and_splice_run_after_inserts_equal(mode):
    """Rebalancing's migration flushes first: after inserts that dirty many
    segments, the batched flush inside it leaves the reference's trees."""
    keys = _straddling_keys()
    pl = np.arange(keys.shape[0])
    ours, ref = _pair(keys, error=32, buffer_size=8, mode=mode, payload=pl)
    new = keys[::7] + 0.5
    ours.insert_many(new, [-1] * new.shape[0])
    for k in new:
        ref.insert(float(k), -1)
    lo, hi = keys[keys.shape[0] // 4], keys[keys.shape[0] // 2]
    got, want = ours.extract_range(lo, hi), ref.extract_range(lo, hi)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    _assert_same(ours, ref)
    ours.insert_many(got[0][::5] + 0.25, [-2] * got[0][::5].shape[0])
    for k in got[0][::5] + 0.25:
        ref.insert(float(k), -2)
    ours.splice_run(got[0], got[1])
    ref.splice_run(want[0], want[1])
    _assert_same(ours, ref)
