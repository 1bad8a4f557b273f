"""The port's window-search kernel vs the reference Pallas kernel.

On the CPU the port runs the kernel's plain torch twin
(``fitting_lookup_torch``); the reference runs ``fitting_lookup_pallas`` in
interpret mode, fed the buckets of its own ``_pallas_bucketize``.  Each
bucketed query is compared with the port's answer for the same query and
window start: ranks are integers and every compare is f32 on both sides, so
the tolerance is 0.  The CUDA kernel itself is held against the twin on the
card by ``tests/test_torch_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.index import SegmentTable as RefTable
from repro.index import engine as ref_engine
from repro.kernels.fitting_lookup import fitting_lookup_pallas
from repro.kernels.ref import lookup_ref as ref_lookup_ref
from repro_torch.index import SegmentTable, device_index, make_plan
from repro_torch.index.engine import predict_positions
from repro_torch.kernels import _build, fitting_lookup as fl
from repro_torch.kernels.ref import lookup_ref


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


def _queries(keys, rng, m=160):
    return np.concatenate([keys[rng.integers(0, keys.shape[0], m)],
                           np.round(rng.uniform(-50, 2 ** 23 + 50, m // 2))])


def _port_qlo(table, q32, plan):
    idx = device_index(table, "cpu")
    pred = predict_positions(idx, torch.from_numpy(q32))
    return (pred - table.error).clamp(0, plan.n_pad - plan.window)


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("n,error,dist,qcap", [
    (1000, 4, "uniform", 256), (20_000, 64, "clustered", 256),
    (5000, 250, "dups", 256), (10_000, 16, "uniform", 128)])
def test_plain_twin_matches_pallas_per_bucketed_query(n, error, dist, qcap,
                                                      side):
    keys = _keys(n, seed=n + error, dist=dist)
    rng = np.random.default_rng(error)
    q = _queries(keys, rng)
    if qcap == 128:                       # one bucket overflows at qcap=128
        q = np.concatenate([q, np.repeat(keys[500], 300)])
    q32 = q.astype(np.float32)

    ref_idx = ref_engine.device_index(RefTable.from_keys(keys, error,
                                                         assume_sorted=True))
    ref_plan = ref_engine.make_plan(n, error)
    q_b, qlo_b, src_b = ref_engine._pallas_bucketize(
        ref_idx, jnp.asarray(q32), ref_plan, qcap)
    rank_b, found_b = fitting_lookup_pallas(
        ref_engine.pad_keys(ref_idx.keys, ref_plan), q_b, qlo_b,
        kb=ref_plan.kb, window=ref_plan.window, interpret=True, side=side)
    src_b, qlo_b = np.asarray(src_b), np.asarray(qlo_b)
    ok = src_b >= 0
    src = src_b[ok]
    if qcap == 128:
        assert src.shape[0] < q.shape[0]  # the overflow really happened

    table = SegmentTable.from_keys(keys, error, assume_sorted=True)
    plan = make_plan(n, error)
    assert plan == tuple(ref_plan)
    qlo = _port_qlo(table, q32, plan)
    np.testing.assert_array_equal(qlo.numpy()[src], qlo_b[ok])  # same windows
    rank, found = fl.fitting_lookup_torch(
        torch.tensor(keys.astype(np.float32)), torch.from_numpy(q32[src]),
        qlo[torch.from_numpy(src)].contiguous(), window=plan.window,
        n_pad=plan.n_pad, side=side)
    np.testing.assert_array_equal(rank.numpy(), np.asarray(rank_b)[ok])
    np.testing.assert_array_equal(found.numpy(), np.asarray(found_b)[ok])


@pytest.mark.parametrize("n_keys,error", [(1000, 4), (10 ** 6, 250), (100, 0),
                                          (129, 63)])
def test_plan_geometry_matches_reference(n_keys, error):
    assert make_plan(n_keys, error) == tuple(ref_engine.make_plan(n_keys,
                                                                  error))


def test_window_padding_reads_as_inf():
    """A window past the column's end compares +inf keys, like the
    reference's +inf padding: `<=` counts them for an +inf query."""
    keys = torch.tensor([1.0, 2.0, 3.0])
    q = torch.tensor([2.5, float("inf"), 3.0])
    qlo = torch.tensor([0, 0, 1], dtype=torch.int32)
    rank, found = fl.fitting_lookup_torch(keys, q, qlo, window=6, n_pad=128,
                                          side="left")
    assert rank.tolist() == [2, 3, 2] and found.tolist() == [False, True, True]
    rank, _ = fl.fitting_lookup_torch(keys, q, qlo, window=6, n_pad=128,
                                      side="right")
    assert rank.tolist() == [2, 6, 3]


def test_cpu_tensors_take_the_plain_twin_without_counting():
    keys = torch.arange(64, dtype=torch.float32)
    q = torch.tensor([3.0, 70.0])
    qlo = torch.tensor([0, 30], dtype=torch.int32)
    before = fl.fitting_lookup_cuda.launches
    got = fl.fitting_lookup_window(keys, q, qlo, window=34, n_pad=128)
    want = fl.fitting_lookup_torch(keys, q, qlo, window=34, n_pad=128)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert fl.fitting_lookup_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        fl.fitting_lookup_cuda(keys, q, qlo, window=34, n_pad=128)
    assert fl.fitting_lookup_cuda.launches == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "side", "n_pad"])
def test_wrapper_rejects_bad_inputs(bad):
    keys = torch.arange(64, dtype=torch.float32)
    q = torch.tensor([3.0, 7.0])
    qlo = torch.tensor([0, 1], dtype=torch.int32)
    kw = {"window": 10, "n_pad": 128, "side": "left"}
    if bad == "dtype":
        qlo = qlo.to(torch.int64)
    elif bad == "shape":
        q = q[:1]
    elif bad == "side":
        kw["side"] = "middle"
    else:
        kw["n_pad"] = 32
    with pytest.raises(ValueError):
        fl.fitting_lookup_window(keys, q, qlo, **kw)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "DEFAULT_NVCC", tmp_path / "nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


def test_library_path_is_keyed_by_source_hash():
    path = _build.library_path("fitting_lookup")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("fitting_lookup-") and path.suffix == ".so"
    assert path == _build.library_path("fitting_lookup")


def test_lookup_ref_matches_reference_oracle():
    keys = _keys(3000, seed=3, dist="dups")
    q = _queries(keys, np.random.default_rng(4)).astype(np.float32)
    got = lookup_ref(torch.tensor(keys.astype(np.float32)), torch.tensor(q))
    want = ref_lookup_ref(jnp.asarray(keys, jnp.float32), jnp.asarray(q))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
