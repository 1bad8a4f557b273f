"""The fused learned-index search's plain twin against the JAX package.

``fitting_search_torch`` is the function the CUDA kernel
``fitting_search_cuda`` computes in one launch (route, interpolate, window,
duplicate snap).  Here, on the CPU, it is held against the reference's
``pallas_lookup`` / ``pallas_search`` (Pallas in interpret mode) and against
``np.searchsorted`` on the f32 column, in all three modes, at e in
{16, 64, 256}.  Ranks are integers and every compare is exact (integer keys
below 2^24, f32-exact queries), so the tolerance is 0.  The kernel itself is
held against this twin on the card by ``tests/test_torch_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.index import SegmentTable as RefTable
from repro.index import engine as ref_engine
from repro_torch.index import SegmentTable, device_index, make_plan
from repro_torch.kernels import fitting_lookup as fl

RUN = 700          # one duplicate run longer than the widest window (514)


def _keys(n, seed):
    """Integer keys with many short duplicate runs and one of RUN keys."""
    rng = np.random.default_rng(seed)
    ks = np.concatenate([rng.choice(n // 2, n - RUN, replace=True) * 3,
                         np.full(RUN, 3 * (n // 4))])
    return np.sort(ks).astype(np.float64)


def _queries(keys, seed, m=300):
    rng = np.random.default_rng(seed)
    return np.concatenate([
        keys[rng.integers(0, keys.shape[0], m)],
        np.round(rng.uniform(-20, keys[-1] + 20, m // 2)),
        [keys[0], keys[-1], 3 * (keys.shape[0] // 4), 2.0 ** 30, -2.0 ** 30],
    ]).astype(np.float32)


def _oracle(keys, q, mode):
    k32 = keys.astype(np.float32)
    left = np.searchsorted(k32, q, "left")
    if mode == "search-left":
        return left
    if mode == "search-right":
        return np.searchsorted(k32, q, "right")
    hit = (left < k32.shape[0]) & (k32[np.minimum(left, k32.shape[0] - 1)]
                                   == q)
    return np.where(hit, left, -1)


def _reference(keys, error, q, mode):
    idx = ref_engine.device_index(RefTable.from_keys(keys, error,
                                                     assume_sorted=True))
    qj = jnp.asarray(q)
    if mode == "lookup":
        return np.asarray(ref_engine.pallas_lookup(idx, qj, interpret=True))
    side = mode.split("-")[1]
    return np.asarray(ref_engine.pallas_search(idx, qj, side, interpret=True))


def _twin(keys, error, q, mode):
    table = SegmentTable.from_keys(keys, error, assume_sorted=True)
    idx = device_index(table, "cpu")
    plan = make_plan(keys.shape[0], error)
    return fl.fitting_search_torch(*idx[:5], torch.from_numpy(q),
                                   error=error, n_pad=plan.n_pad,
                                   mode=mode).numpy(), table


@pytest.mark.parametrize("mode", fl.MODES)
@pytest.mark.parametrize("error", [16, 64, 256])
def test_fused_twin_matches_pallas_and_searchsorted(error, mode):
    keys = _keys(3000, seed=error)
    q = _queries(keys, seed=error + 1)
    got, table = _twin(keys, error, q, mode)
    # the data is adversarial where it should be: some duplicate run
    # straddles a segment boundary, and one is longer than the window
    starts = np.asarray(table.base[1:], np.int64)
    assert np.any(keys[starts - 1] == keys[starts])
    assert RUN > 2 * error + 2
    np.testing.assert_array_equal(got, _reference(keys, error, q, mode))
    np.testing.assert_array_equal(got, _oracle(keys, q, mode))


@pytest.mark.parametrize("mode", fl.MODES)
def test_fused_twin_takes_an_empty_batch(mode):
    keys = _keys(1000, seed=3)
    got, _ = _twin(keys, 16, np.zeros(0, np.float32), mode)
    assert got.shape == (0,) and got.dtype == np.int32


def test_fused_dispatch_takes_the_twin_for_cpu_tensors_without_counting():
    keys = _keys(1000, seed=4)
    idx = device_index(SegmentTable.from_keys(keys, 16, assume_sorted=True),
                       "cpu")
    q = torch.from_numpy(_queries(keys, seed=5, m=50))
    kw = {"error": 16, "n_pad": make_plan(keys.shape[0], 16).n_pad,
          "mode": "search-right"}
    before = fl.fitting_search_cuda.launches
    got = fl.fitting_search(*idx[:5], q, **kw)
    assert torch.equal(got, fl.fitting_search_torch(*idx[:5], q, **kw))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fl.fitting_search_cuda(*idx[:5], q, **kw)
    assert fl.fitting_search_cuda.launches == before


@pytest.mark.parametrize("bad", ["mode", "dtype", "n_pad", "segments"])
def test_fused_wrapper_rejects_bad_inputs(bad):
    keys = _keys(1000, seed=6)
    idx = list(device_index(SegmentTable.from_keys(keys, 16,
                                                   assume_sorted=True),
                            "cpu")[:5])
    q = torch.tensor([3.0, 7.0])
    kw = {"error": 16, "n_pad": make_plan(keys.shape[0], 16).n_pad,
          "mode": "lookup"}
    if bad == "mode":
        kw["mode"] = "search"
    elif bad == "dtype":
        idx[2] = idx[2].to(torch.int64)
    elif bad == "n_pad":
        kw["n_pad"] = keys.shape[0] - 1
    else:
        idx[1] = idx[1][:-1]
    with pytest.raises(ValueError):
        fl.fitting_search(*idx, q, **kw)
