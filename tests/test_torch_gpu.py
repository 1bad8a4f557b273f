"""The port's CUDA kernel on the card (marked ``gpu``; skips without one).

These tests import neither JAX nor the JAX package, so they run on a
machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

The kernel is held against its plain torch twin on the same inputs, and the
``cuda`` engine against ``np.searchsorted``: ranks are integers and every
compare is f32 on both sides, so the tolerance is 0.
"""
import numpy as np
import pytest
import torch

from repro_torch.index import SegmentTable, device_index, make_engine, \
    make_plan
from repro_torch.index.engine import predict_positions
from repro_torch.kernels import fitting_lookup as fl


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _dup_keys(n, seed):
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(n // 3, size=n, replace=True)).astype(np.float64)


def _queries(keys, rng, m):
    return np.concatenate([keys[rng.integers(0, keys.shape[0], m)],
                           np.round(rng.uniform(-50, keys[-1] + 50, m // 2))])


@pytest.mark.gpu
@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("error", [0, 16, 250])
def test_cuda_kernel_matches_plain_twin(cuda_device, error, side):
    keys = _dup_keys(50_000, seed=error)
    table = SegmentTable.from_keys(keys, error, assume_sorted=True)
    plan = make_plan(keys.shape[0], error)
    q32 = _queries(keys, np.random.default_rng(5), 4097).astype(np.float32)
    pred = predict_positions(device_index(table, "cpu"), torch.from_numpy(q32))
    qlo = (pred - error).clamp(0, plan.n_pad - plan.window)
    args = [torch.tensor(keys.astype(np.float32)), torch.from_numpy(q32), qlo]
    kw = {"window": plan.window, "n_pad": plan.n_pad, "side": side}
    want = fl.fitting_lookup_torch(*args, **kw)
    before = fl.fitting_lookup_cuda.launches
    got = fl.fitting_lookup_cuda(*[a.to(cuda_device) for a in args], **kw)
    torch.cuda.synchronize()
    assert fl.fitting_lookup_cuda.launches == before + 1
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.gpu
def test_cuda_engine_defaults_to_the_card_and_launches(cuda_device):
    keys = _dup_keys(30_000, seed=1)
    eng = make_engine(SegmentTable.from_keys(keys, 32, assume_sorted=True),
                      "cuda")
    assert eng.device.type == "cuda" and eng.index.keys.is_cuda
    q = _queries(keys, np.random.default_rng(2), 1000)
    before = fl.fitting_lookup_cuda.launches
    for side in ("left", "right"):
        np.testing.assert_array_equal(eng.search(q, side),
                                      np.searchsorted(keys, q, side))
    left = np.searchsorted(keys, q, "left")
    hit = (left < keys.shape[0]) & (keys[np.minimum(left, keys.shape[0] - 1)]
                                    == q)
    np.testing.assert_array_equal(eng.lookup(q), np.where(hit, left, -1))
    assert fl.fitting_lookup_cuda.launches == before + 3
