"""Torch port vs the JAX package: segmentation, datasets and the SegmentTable.

The host modules of the port are copies of the reference's numpy code, so the
tolerance is 0: the same segment starts, slopes and bases, the same keys for
the same seed, and the same ranks from the host searches.  A table built by
the reference and carried across with ``SegmentTable.from_state`` answers
like the port's own.
"""
import numpy as np
import pytest

from repro.core import datasets as ref_datasets
from repro.core import segmentation as ref_seg
from repro.index import table as ref_table
from repro_torch.core import datasets, segmentation as seg
from repro_torch.index import SegmentTable, make_engine
from repro_torch.index import table as port_table

TABLE_FIELDS = ("start_key", "slope", "base", "seg_end", "keys")


def _sorted_floats(seed: int, n: int) -> np.ndarray:
    """Inputs shaped like tests/test_segmentation.py's: sorted floats in
    [-1e9, 1e9], a few duplicated."""
    rng = np.random.default_rng(seed)
    xs = rng.uniform(-1e9, 1e9, n)
    xs[rng.integers(0, n, n // 10)] = xs[0]
    return np.sort(xs)


def _keys(dist: str, n: int = 3000, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dist == "uniform":
        return np.sort(rng.choice(2 ** 23, n, replace=False)).astype(float)
    if dist == "dups":
        return np.sort(rng.choice(2 ** 12, n)).astype(float)
    return np.sort(rng.lognormal(0.0, 2.0, n) * 1e6)


def _assert_same_table(a, b):
    for f in TABLE_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert (a.error, a.epoch) == (b.error, b.epoch)


def _assert_same_segments(a, b):
    for f in ("start_key", "slope", "base", "count"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert a.error == b.error


@pytest.mark.parametrize("mode", ["paper", "clamped"])
@pytest.mark.parametrize("error", [1, 4, 16, 64])
@pytest.mark.parametrize("seed", range(4))
def test_shrinking_cone_matches_reference(seed, error, mode):
    xs = _sorted_floats(seed, 50 + 90 * seed)
    _assert_same_segments(seg.shrinking_cone(xs, error, mode=mode),
                          ref_seg.shrinking_cone(xs, error, mode=mode))
    _assert_same_segments(seg.shrinking_cone_py(xs, error, mode=mode),
                          ref_seg.shrinking_cone_py(xs, error, mode=mode))


@pytest.mark.parametrize("error", [2, 8, 32])
def test_optimal_segmentation_and_bounds_match_reference(error):
    xs = _sorted_floats(error, 300)
    assert seg.optimal_segmentation(xs, error) == \
        ref_seg.optimal_segmentation(xs, error)
    ours = seg.optimal_segmentation(xs, error, return_segments=True)
    _assert_same_segments(
        ours, ref_seg.optimal_segmentation(xs, error, return_segments=True))
    assert seg.verify_segments(xs, ours) == ref_seg.verify_segments(xs, ours)
    assert seg.verify_segments(xs, ours) <= error + 1e-6
    assert seg.max_segments_bound(300, 300, error) == \
        ref_seg.max_segments_bound(300, 300, error)


@pytest.mark.parametrize("name", sorted(datasets.DATASETS))
def test_datasets_match_reference(name):
    np.testing.assert_array_equal(datasets.DATASETS[name](5000),
                                  ref_datasets.DATASETS[name](5000))
    keys = datasets.DATASETS[name](5000)
    assert datasets.non_linearity_ratio(keys, 16) == \
        ref_datasets.non_linearity_ratio(keys, 16)


@pytest.mark.parametrize("dist", ["uniform", "dups", "lognormal"])
@pytest.mark.parametrize("error", [4, 64])
def test_table_and_host_searches_match_reference(dist, error):
    keys = _keys(dist, seed=error)
    ours = SegmentTable.from_keys(keys, error, assume_sorted=True)
    ref = ref_table.SegmentTable.from_keys(keys, error, assume_sorted=True)
    _assert_same_table(ours, ref)
    rng = np.random.default_rng(1)
    q = np.concatenate([keys[rng.integers(0, keys.shape[0], 200)],
                        rng.uniform(keys[0] - 5, keys[-1] + 5, 100)])
    np.testing.assert_array_equal(ours.predict(q), ref.predict(q))
    np.testing.assert_array_equal(ours.window(q)[0], ref.window(q)[0])
    np.testing.assert_array_equal(ours.window(q)[1], ref.window(q)[1])
    np.testing.assert_array_equal(port_table.route_keys(ours.start_key, q),
                                  ref_table.route_keys(ref.start_key, q))
    np.testing.assert_array_equal(port_table.numpy_lookup(ours, q),
                                  ref_table.numpy_lookup(ref, q))
    for side in ("left", "right"):
        got = port_table.numpy_search(ours, q, side)
        np.testing.assert_array_equal(got, ref_table.numpy_search(ref, q, side))
        np.testing.assert_array_equal(got, np.searchsorted(keys, q, side))
    assert ours.max_abs_error() == ref.max_abs_error()


def test_shard_helpers_match_reference():
    keys = _keys("dups", n=4000, seed=5)
    for shards in (1, 3, 8):
        np.testing.assert_array_equal(
            port_table.shard_cut_indices(keys, shards),
            ref_table.shard_cut_indices(keys, shards))
        np.testing.assert_array_equal(
            port_table.shard_boundaries(keys, shards),
            ref_table.shard_boundaries(keys, shards))
        b_ours, s_ours = port_table.shard_partition(keys, shards)
        b_ref, s_ref = ref_table.shard_partition(keys, shards)
        np.testing.assert_array_equal(b_ours, b_ref)
        for a, b in zip(s_ours, s_ref, strict=True):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(port_table.build_shard_tables(keys, 16, 4),
                    ref_table.build_shard_tables(keys, 16, 4), strict=True):
        _assert_same_table(a, b)
    with pytest.raises(ValueError):
        port_table.shard_cut_indices(np.zeros(10), 2)


def _state_of(table) -> dict:
    """A reference table's state, taken field by field (the reference has
    no ``to_state``)."""
    return {f: np.asarray(getattr(table, f)) for f in TABLE_FIELDS} | {
        "error": table.error, "epoch": table.epoch}


@pytest.mark.parametrize("dist", ["uniform", "dups"])
def test_from_state_carries_reference_table(dist):
    keys = _keys(dist, seed=7)
    ref = ref_table.SegmentTable.from_keys(keys, 16, assume_sorted=True,
                                           epoch=3)
    carried = SegmentTable.from_state(_state_of(ref))
    own = SegmentTable.from_keys(keys, 16, assume_sorted=True, epoch=3)
    _assert_same_table(carried, own)
    assert (carried.error, carried.epoch) == (16, 3)
    assert all(not getattr(carried, f).flags.writeable for f in TABLE_FIELDS)
    _assert_same_table(SegmentTable.from_state(own.to_state()), own)
    rng = np.random.default_rng(8)
    q = np.concatenate([keys[rng.integers(0, keys.shape[0], 300)],
                        rng.uniform(-10, 2 ** 23, 100)])
    for backend in ("numpy", "torch-window", "torch-bisect", "cuda"):
        a = make_engine(carried, backend, device="cpu")
        b = make_engine(own, backend, device="cpu")
        np.testing.assert_array_equal(a.lookup(q), b.lookup(q))
        for side in ("left", "right"):
            np.testing.assert_array_equal(a.search(q, side),
                                          b.search(q, side))


def test_from_state_copies_the_callers_buffers():
    keys = np.arange(100.0)
    state = SegmentTable.from_keys(keys, 4).to_state()
    state = {k: (np.array(v) if isinstance(v, np.ndarray) else v)
             for k, v in state.items()}
    table = SegmentTable.from_state(state)
    state["keys"][0] = -1.0
    assert table.keys[0] == 0.0


def test_empty_table():
    table = SegmentTable.empty(8, epoch=2)
    _assert_same_table(table, ref_table.SegmentTable.empty(8, epoch=2))
    assert table.n_keys == 0 and table.n_segments == 1
    np.testing.assert_array_equal(port_table.numpy_lookup(table, [1.0]), [-1])
    np.testing.assert_array_equal(port_table.numpy_search(table, [1.0]), [0])
