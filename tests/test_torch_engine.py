"""Every lookup backend of the torch port vs its JAX-package counterpart.

Backends map ``numpy -> numpy``, ``torch-window -> xla-window``,
``torch-bisect -> xla-bisect`` and ``cuda -> pallas``; on the CPU the port's
``cuda`` backend runs the kernel's plain torch twin and the reference's
``pallas`` backend runs its kernel in interpret mode.  Both packages get the
same keys and queries, made from a seed with numpy, and every answer is
compared with the other package's and with ``np.searchsorted`` on the
column.  Keys are integers below 2^23 and queries are exact in f32, so every
compare agrees bit for bit: the tolerance is 0.  Duplicated keys answer with
the leftmost rank.
"""
import numpy as np
import pytest
import torch

from repro.index import SegmentTable as RefTable
from repro.index import make_engine as ref_make_engine
from repro_torch.index import (DispatchEngine, SegmentTable, make_engine,
                               resolve_device)

REF_BACKEND = {"numpy": "numpy", "torch-window": "xla-window",
               "torch-bisect": "xla-bisect", "cuda": "pallas"}
BACKENDS = sorted(REF_BACKEND)


def _keys(n, seed=0, dist="uniform"):
    rng = np.random.default_rng(seed)
    if dist == "uniform":
        ks = rng.choice(2 ** 23, size=n, replace=False)
    elif dist == "clustered":
        centers = rng.choice(2 ** 22, size=max(4, n // 200), replace=False)
        ks = (centers[rng.integers(0, len(centers), n)]
              + rng.integers(0, 2 ** 10, n))
    else:
        ks = rng.choice(2 ** 12, size=n, replace=True)
    return np.sort(ks).astype(np.float64)


def _queries(keys, rng, m=128):
    """Present keys, gaps (key + 0.5, exact in f32) and integers around the
    key domain, out-of-domain on both sides included."""
    n = keys.shape[0]
    return np.concatenate([
        keys[rng.integers(0, n, m)], keys[rng.integers(0, n, m // 2)] + 0.5,
        np.round(rng.uniform(keys[0] - 64, keys[-1] + 64, m // 2)),
        [keys[0] - 1.0, keys[-1] + 1.0, -1e6, 2.0 ** 23 + 8]])


def _oracle(keys, q):
    k32, q32 = keys.astype(np.float32), np.asarray(q, np.float32)
    left = np.searchsorted(k32, q32, "left")
    right = np.searchsorted(k32, q32, "right")
    found = (left < k32.shape[0]) & (k32[np.minimum(left, k32.shape[0] - 1)]
                                     == q32)
    return np.where(found, left, -1), left, right


def _answers(eng, q):
    return (eng.lookup(q), eng.search(q, "left"), eng.search(q, "right"))


def _check(backend, keys, error, q, qcap=256, sizes=None):
    """Port vs reference vs oracle on ``q``; with ``sizes``, the port also
    answers each prefix ``q[:size]`` as a batch of its own, held to the
    prefix of the full batch's answers (every answer is per query)."""
    ref_opts = {"qcap": qcap} if backend == "cuda" else {}
    ref = ref_make_engine(RefTable.from_keys(keys, error, assume_sorted=True),
                          REF_BACKEND[backend], **ref_opts)
    port = make_engine(SegmentTable.from_keys(keys, error, assume_sorted=True),
                       backend, device="cpu")
    ref_ans, want = _answers(ref, q), _oracle(keys, q)
    for size in sizes or (q.shape[0],):
        for name, got, ref_got, oracle in zip(
                ("lookup", "search left", "search right"),
                _answers(port, q[:size]), ref_ans, want, strict=True):
            what = f"{name}, batch of {size}"
            np.testing.assert_array_equal(got, ref_got[:size],
                                          err_msg=f"{what} vs ref")
            np.testing.assert_array_equal(got, oracle[:size],
                                          err_msg=f"{what} vs oracle")


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n", [100, 1000, 20_000])
@pytest.mark.parametrize("error", [4, 16, 64, 250])
def test_sweep_sizes_errors(backend, n, error):
    keys = _keys(n, seed=n + error)
    _check(backend, keys, error, _queries(keys, np.random.default_rng(1)))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("dist", ["uniform", "clustered", "dups"])
def test_sweep_distributions(backend, dist):
    keys = _keys(5000, seed=7, dist=dist)
    _check(backend, keys, 32, _queries(keys, np.random.default_rng(2), m=200))


@pytest.mark.parametrize("backend", BACKENDS)
def test_query_batch_edge_sizes(backend):
    keys = _keys(2000, seed=4, dist="dups")
    _check(backend, keys, 8, keys[np.arange(129) * 7 % keys.shape[0]],
           sizes=(1, 2, 127, 128, 129))


@pytest.mark.parametrize("backend", BACKENDS)
def test_identical_queries_overflowing_a_reference_bucket(backend):
    """300 queries in one key block overflow the reference kernel's bucket
    at qcap=128 (it falls back to XLA); the port has no buckets."""
    keys = _keys(10_000, seed=3)
    _check(backend, keys, 16, np.repeat(keys[500], 300), qcap=128)


@pytest.mark.parametrize("backend", BACKENDS)
def test_duplicate_run_longer_than_the_window(backend):
    keys = np.sort(np.concatenate([np.arange(0.0, 3000.0, 3.0),
                                   np.full(700, 1501.0)]))
    q = np.array([1501.0, 1500.0, 1502.0, 1501.5, 0.0, 3000.0])
    _check(backend, keys, 4, q)


def test_dispatch_tiers_match_reference_dispatch():
    keys = _keys(5000, seed=9, dist="dups")
    tiers = {"small_max": 4, "large_min": 64}
    ref = ref_make_engine(RefTable.from_keys(keys, 16, assume_sorted=True),
                          "dispatch", **tiers)
    port = make_engine(SegmentTable.from_keys(keys, 16, assume_sorted=True),
                       "dispatch", device="cpu", **tiers)
    assert isinstance(port, DispatchEngine)
    assert port.TIERS == ("numpy", "torch-bisect", "cuda")
    rng = np.random.default_rng(10)
    for size, backend in ((3, "numpy"), (40, "torch-bisect"), (200, "cuda")):
        q = _queries(keys, rng)[:size]
        assert port.backend_for(size) == backend
        for got, want, oracle in zip(_answers(port, q), _answers(ref, q),
                                     _oracle(keys, q), strict=True):
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, oracle)
    assert set(port._engines) == {"numpy", "torch-bisect", "cuda"}


def test_prewarm_builds_every_dispatch_tier_and_changes_no_answer():
    keys = _keys(3000, seed=13, dist="dups")
    table = SegmentTable.from_keys(keys, 16, assume_sorted=True)
    port = make_engine(table, "dispatch", device="cpu", small_max=2,
                       large_min=64)
    port.prewarm()
    assert set(port._engines) == set(DispatchEngine.TIERS)
    q = _queries(keys, np.random.default_rng(14))
    for got, oracle in zip(_answers(port, q), _oracle(keys, q), strict=True):
        np.testing.assert_array_equal(got, oracle)
    make_engine(SegmentTable.empty(16), "cuda", device="cpu").prewarm()


def test_dispatch_needs_explicit_thresholds():
    """Thresholds are both given or both left to the cost model (the
    card's default profile, as the reference derives its own)."""
    from repro_torch.core.cost_model import dispatch_thresholds
    table = SegmentTable.from_keys(np.arange(100.0), 8)
    eng = make_engine(table, "dispatch", device="cpu")
    assert (eng.small_max, eng.large_min) == dispatch_thresholds(
        table.error, table.n_segments)
    with pytest.raises(ValueError, match="both small_max and large_min"):
        make_engine(table, "dispatch", device="cpu", small_max=8)
    with pytest.raises(ValueError, match="small_max < large_min"):
        make_engine(table, "dispatch", device="cpu", small_max=8, large_min=8)


@pytest.mark.parametrize("backend", ["cuda", "torch-window", "torch-bisect"])
def test_device_backends_default_to_cuda_and_raise_without_a_card(
        backend, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    table = SegmentTable.from_keys(np.arange(100.0), 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_engine(table, backend)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_engine(table)               # the default backend is cuda
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


def test_device_form_is_cached_per_device_and_exact_in_f32():
    keys = _keys(3000, seed=11)
    table = SegmentTable.from_keys(keys, 16, assume_sorted=True)
    a = make_engine(table, "cuda", device="cpu")
    b = make_engine(table, "torch-window", device="cpu")
    assert a.index is b.index
    assert a.index.keys.dtype == torch.float32
    assert a.index.base.dtype == torch.int32
    np.testing.assert_array_equal(a.index.keys.numpy(), keys)


def test_torch_tensor_queries_keep_their_shape():
    keys = _keys(1000, seed=12)
    eng = make_engine(SegmentTable.from_keys(keys, 8, assume_sorted=True),
                      "cuda", device="cpu")
    q = keys[:12].reshape(3, 4)
    got = eng.lookup(torch.tensor(q))
    assert got.shape == (3, 4)
    np.testing.assert_array_equal(got, eng.lookup(q))
    np.testing.assert_array_equal(eng.search(torch.tensor(q), "right"),
                                  np.searchsorted(keys, q, "right"))
