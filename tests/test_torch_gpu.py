"""The port's CUDA kernels on the card (marked ``gpu``; skip without one).

These tests import neither JAX nor the JAX package, so they run on a
machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Each kernel is held against its plain torch twin on the same inputs.  The
lookup kernels (the window search alone and the fused search) and the
``cuda`` engine (against ``np.searchsorted``) to tolerance 0: ranks are
integers and every compare is f32 on both sides.
The RG-LRU scan to tolerance 0 as well (see its test); flash attention to
the reference's tolerances (stated at ``FLASH_TOL``).  The sharded write
path and the LSM on the card to their own host ``numpy`` backend (and the
LSM to ``np.searchsorted`` on its live multiset), to tolerance 0; the async
front door to ``np.searchsorted``, launching the fused kernel.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.datasets import iot_like
from repro_torch.core.torch_index import rescale_keys
from repro_torch.index import SegmentTable, device_index, make_engine, \
    make_plan
from repro_torch.index.engine import predict_positions
from repro_torch.kernels import fitting_lookup as fl
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rglru_scan as rs


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
    before = fl.fitting_search_cuda.launches
    for side in ("left", "right"):
        np.testing.assert_array_equal(eng.search(q, side),
                                      np.searchsorted(keys, q, side))
    left = np.searchsorted(keys, q, "left")
    hit = (left < keys.shape[0]) & (keys[np.minimum(left, keys.shape[0] - 1)]
                                    == q)
    np.testing.assert_array_equal(eng.lookup(q), np.where(hit, left, -1))
    # one launch of the fused kernel for each of search left, right, lookup
    assert fl.fitting_search_cuda.launches == before + 3


def _smoke_keys(n):
    """The smoke's data at a smaller n: iot_like, rescaled, floored."""
    scaled, _, _ = rescale_keys(iot_like(n, seed=0))
    return np.floor(scaled)


@pytest.mark.gpu
@pytest.mark.parametrize("data", ["smoke", "dups"])
@pytest.mark.parametrize("error", [0, 16, 64, 256])
def test_fused_kernel_matches_plain_twin(cuda_device, data, error):
    """Tolerance 0 in every mode, on the smoke's keys (2^18 of them, 2^16
    queries, some far outside the domain) and on heavy duplicates with runs
    longer than the window and runs across segment boundaries."""
    if data == "smoke":
        keys = _smoke_keys(2 ** 18)
        rng = np.random.default_rng(error)
        q = np.concatenate([keys[rng.integers(0, keys.shape[0], 2 ** 15)],
                            rng.integers(-2 ** 10, int(keys[-1]) + 2 ** 10,
                                         2 ** 15 - 2),
                            [2.0 ** 30, -2.0 ** 30]])
    else:
        keys = np.sort(np.concatenate([_dup_keys(40_000, seed=error),
                                       np.full(1500, 7.0)]))
        q = _queries(keys, np.random.default_rng(error + 1), 4097)
    table = SegmentTable.from_keys(keys, error, assume_sorted=True)
    n_pad = make_plan(keys.shape[0], error).n_pad
    cpu = device_index(table, "cpu")
    gpu = device_index(table, cuda_device)
    q32 = torch.from_numpy(q.astype(np.float32))
    for mode in fl.MODES:
        want = fl.fitting_search_torch(*cpu[:5], q32, error=error,
                                       n_pad=n_pad, mode=mode)
        before = fl.fitting_search_cuda.launches
        got = fl.fitting_search_cuda(*gpu[:5], q32.to(cuda_device),
                                     error=error, n_pad=n_pad, mode=mode)
        torch.cuda.synchronize()
        assert fl.fitting_search_cuda.launches == before + 1
        assert torch.equal(got.cpu(), want), mode


@pytest.mark.gpu
def test_fused_kernel_stages_wide_tables_on_every_card_and_stream(
        cuda_device):
    """A segment table of 3,072 < S <= 4,096 entries is staged whole in
    S * 16 > 48 KB of shared memory, which takes the kernel's opt-in and a
    grid sized from the card it runs on: both are asked for each card.
    Every card present, each on a stream of its own, tolerance 0."""
    keys = _smoke_keys(2 ** 18)
    error = 7
    table = SegmentTable.from_keys(keys, error, assume_sorted=True)
    assert 3072 < table.n_segments <= 4096
    n_pad = make_plan(keys.shape[0], error).n_pad
    rng = np.random.default_rng(3)
    q = np.concatenate([keys[rng.integers(0, keys.shape[0], 2 ** 15)],
                        rng.integers(-2 ** 10, int(keys[-1]) + 2 ** 10,
                                     2 ** 15)])
    q32 = torch.from_numpy(q.astype(np.float32))
    cpu = device_index(table, "cpu")
    for i in reversed(range(torch.cuda.device_count())):
        dev = torch.device("cuda", i)
        gpu = device_index(table, dev)
        stream = torch.cuda.Stream(device=dev)
        for mode in fl.MODES:
            want = fl.fitting_search_torch(*cpu[:5], q32, error=error,
                                           n_pad=n_pad, mode=mode)
            qd = q32.to(dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                got = fl.fitting_search_cuda(*gpu[:5], qd, error=error,
                                             n_pad=n_pad, mode=mode)
            stream.synchronize()
            assert got.device == dev
            assert torch.equal(got.cpu(), want), (i, mode)


# ------------------------------------------------------------ LM kernels

# bf16 2e-2 and f32 2e-4: the reference's bounds for a blocked against a
# dense softmax (tests/test_kernels_extra.py); the kernel and the twin both
# accumulate in f32 but sum in another order.
FLASH_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-4}


def _qkv(dev, b, h, hkv, tq, s, hd, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=dev).to(dtype)
            for shape in ((b, h, tq, hd), (b, hkv, s, hd), (b, hkv, s, hd))]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,kw,dtype", [
    ((1, 16, 1, 4096, 4096, 256), {"window": 2048}, torch.bfloat16),
    ((2, 8, 4, 300, 300, 128), {"softcap": 50.0}, torch.float32),
    ((2, 4, 2, 100, 200, 64), {"causal": False}, torch.float32),
    ((1, 4, 4, 256, 256, 32), {"window": 64, "softcap": 50.0},
     torch.float32),
    ((2, 8, 2, 1, 512, 16), {}, torch.bfloat16),
    ((1, 2, 1, 130, 130, 64), {"window": 7}, torch.bfloat16),
])
def test_flash_kernel_matches_plain_twin(cuda_device, shape, kw, dtype):
    q, k, v = _qkv(cuda_device, *shape, dtype, seed=sum(shape))
    before = fa.flash_attention_cuda.launches
    got = fa.flash_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention_cuda.launches == before + 1
    want = fa.flash_attention_torch(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == q.shape
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("shape,kw", [
    ((1, 16, 1, 300, 300), {"window": 2048}),
    ((2, 4, 2, 130, 130), {"window": 7}),
    ((1, 4, 4, 256, 256), {"causal": False}),
    ((2, 8, 4, 130, 300), {"softcap": 50.0}),
    ((1, 16, 1, 100, 2300), {"window": 2048}),
    ((2, 4, 1, 77, 300), {"causal": False, "window": 64}),
])
def test_flash_wgmma_path_matches_plain_twin(cuda_device, hd, shape, kw):
    """The bf16 tensor-core kernel: GQA (Hkv 1 under H 16), Tq < S, ragged
    T, causal or not, windows 7 to 2048, softcap."""
    assert fa.kernel_path(torch.bfloat16, hd) == "wgmma"
    q, k, v = _qkv(cuda_device, *shape, hd, torch.bfloat16,
                   seed=sum(shape) + hd)
    before = fa.flash_attention_cuda.launches
    got = fa.flash_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention_cuda.launches == before + 1
    want = fa.flash_attention_torch(q, k, v, **kw)
    tol = FLASH_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_flash_wgmma_path_takes_strided_views(cuda_device, hd):
    """The model's (B, T, H, hd) projections as (B, H, T, hd) views, and a
    slice along T, read in place through TMA."""
    x = torch.randn(2, 200, 6, hd, device=cuda_device).to(torch.bfloat16)
    kv = torch.randn(2, 200, 2, hd, device=cuda_device).to(torch.bfloat16)
    q, k = x.transpose(1, 2)[:, :, 8:], kv.transpose(1, 2)
    got = fa.flash_attention_cuda(q, k, k, window=48)
    want = fa.flash_attention_torch(q.contiguous(), k.contiguous(),
                                    k.contiguous(), window=48)
    tol = FLASH_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
def test_flash_kernel_takes_strided_views(cuda_device):
    """The model hands (B, T, H, hd) projections over as (B, H, T, hd)
    views: the kernel reads them in place."""
    x = torch.randn(2, 96, 6, 64, device=cuda_device)
    kv = torch.randn(2, 96, 2, 64, device=cuda_device)
    q, k = x.transpose(1, 2), kv.transpose(1, 2)
    got = fa.flash_attention_cuda(q, k, k, window=16)
    want = fa.flash_attention_torch(q.contiguous(), k.contiguous(),
                                    k.contiguous(), window=16)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


def _scan_inputs(device, b, t, w, with_h0, offset=0):
    """u, a (and h0) on the card; ``offset`` floats into their storage."""
    g = torch.Generator(device=device).manual_seed(b * t + w + offset)
    u = torch.randn(offset + b * t * w, generator=g, device=device)
    a = torch.rand(offset + b * t * w, generator=g, device=device)
    u, a = (x[offset:].view(b, t, w) for x in (u, a))
    h0 = torch.randn(b, w, generator=g, device=device) if with_h0 else None
    return u, a, h0


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,w,with_h0,offset,path", [
    (4, 4096, 4096, True, 0, "tma"), (1, 3072, 4096, True, 0, "tma"),
    (2, 1000, 96, False, 0, "tma"), (3, 37, 64, False, 0, "tma"),
    (2, 1000, 100, True, 0, "tma"), (1, 5, 4, False, 0, "tma"),
    (1, 1, 130, True, 0, "unaligned"), (2, 0, 64, True, 0, "unaligned"),
    (2, 300, 64, True, 1, "unaligned")])
def test_rglru_kernel_matches_plain_twin(cuda_device, b, t, w, with_h0,
                                         offset, path):
    """Each step rounds its product and its sum as the twin's separate
    multiply and add do, in time order, on both paths, so each agrees with
    the twin bit for bit; the path is the one scan_path names.  W 100 and
    W 4 leave the last channel tile partial (zero-filled loads, lanes past
    W, a store clipped at W); the last case is a view off 16-byte
    alignment."""
    u, a, h0 = _scan_inputs(cuda_device, b, t, w, with_h0, offset)
    assert rs.scan_path(u, a) == path
    before = dict(rs.rglru_scan_cuda.launches_by_path)
    total = rs.rglru_scan_cuda.launches
    got, got_last = rs.rglru_scan_cuda(u, a, h0)
    torch.cuda.synchronize()
    assert rs.rglru_scan_cuda.launches == total + 1
    assert rs.rglru_scan_cuda.launches_by_path == {
        p: n + (p == path) for p, n in before.items()}
    want, want_last = rs.rglru_scan_torch(u, a, h0)
    assert torch.equal(got, want) and torch.equal(got_last, want_last)


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,w,with_h0", [(1, 3072, 4096, True),
                                           (2, 1000, 96, False),
                                           (2, 1000, 100, True)])
def test_rglru_unaligned_kernel_equals_tma_kernel(cuda_device, b, t, w,
                                                  with_h0):
    """The old design, run on aligned inputs through the private entry,
    equals the TMA kernel bit for bit."""
    u, a, h0 = _scan_inputs(cuda_device, b, t, w, with_h0)
    before = dict(rs.rglru_scan_cuda.launches_by_path)
    tma = rs._rglru_scan_launch(u, a, h0, "tma")
    old = rs._rglru_scan_launch(u, a, h0, "unaligned")
    torch.cuda.synchronize()
    assert rs.rglru_scan_cuda.launches_by_path == {
        p: n + 1 for p, n in before.items()}
    assert torch.equal(tma[0], old[0]) and torch.equal(tma[1], old[1])


# --------------------------------------------------- write path on the card
def _verbs(svc, q, backend):
    lo, hi = q, q + 37
    return (svc.search(q, "left", backend=backend),
            svc.search(q, "right", backend=backend),
            svc.lookup(q, backend=backend),
            svc.point(q, backend=backend).rank,
            svc.predecessor(q, backend=backend).rank,
            svc.successor(q, backend=backend).rank,
            svc.count(lo, hi, backend=backend),
            svc.range(float(q[0]), float(q[0]) + 500, backend=backend).keys)


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["cuda", "torch-bisect", "dispatch"])
def test_sharded_service_on_the_card_matches_its_numpy_backend(
        cuda_device, backend):
    """Insert -> publish -> every verb: the card's backends give the host
    numpy backend's answers exactly (integer keys, f32-exact)."""
    from repro_torch.index import ShardedIndexService
    keys = _dup_keys(60_000, seed=3)
    svc = ShardedIndexService(keys, error=32, n_shards=4, buffer_size=8,
                              assume_sorted=True)
    assert svc.default_backend == "cuda"
    rng = np.random.default_rng(4)
    for k in rng.integers(0, 20_000, 3_000):
        svc.insert(float(k))
    svc.publish()
    for size in (1, 700, 9_000):
        q = _queries(keys, rng, size)[:size]
        for got, want in zip(_verbs(svc, q, backend),
                             _verbs(svc, q, "numpy")):
            np.testing.assert_array_equal(got, want)
    if backend != "dispatch":        # dispatch sent these batches to numpy
        idx = svc.handles[0].current().table._device_cache
        assert any(d.type == "cuda" for d in idx)


@pytest.mark.gpu
@pytest.mark.parametrize("payload,publish_every", [(False, None),
                                                   (True, 700)])
def test_sharded_insert_many_on_the_card_equals_the_loop(
        cuda_device, payload, publish_every):
    """``insert_many`` against the loop of ``insert`` on services serving
    from the card: the same trees, pending counts and epochs after batches
    that cross the publish cadence, and the same answers."""
    from repro_torch.index import ShardedIndexService
    keys = _dup_keys(90_000, seed=9)
    pl = np.arange(keys.size) * 2 if payload else None
    kw = dict(error=64, n_shards=9, buffer_size=16, payload=pl,
              publish_every=publish_every, assume_sorted=True)
    loop, batch = ShardedIndexService(keys, **kw), \
        ShardedIndexService(keys, **kw)
    rng = np.random.default_rng(10)
    for size in (1, 500, 3_000):
        new = np.concatenate([keys[rng.integers(0, keys.size, size // 2)],
                              np.round(rng.uniform(-20, keys[-1] + 20,
                                                   size - size // 2))])
        vals = list(range(size)) if payload else None
        for i, k in enumerate(new):
            loop.insert(float(k), None if vals is None else vals[i])
        batch.insert_many(new, vals)
        assert batch._pending == loop._pending
        assert batch.epochs() == loop.epochs()
        for a, b in zip(batch.writers, loop.writers):
            np.testing.assert_array_equal(a.start_keys, b.start_keys)
            assert a.buffers == b.buffers
            assert a.buf_payloads == b.buf_payloads
            assert all(np.array_equal(x, y) for x, y in zip(a.pages,
                                                              b.pages))
        q = _queries(keys, rng, 5_000)
        for got, want in zip(_verbs(batch, q, "cuda"),
                             _verbs(loop, q, "cuda")):
            np.testing.assert_array_equal(got, want)
    batch.publish(), loop.publish()
    q = _queries(keys, rng, 5_000)
    for got, want in zip(_verbs(batch, q, "cuda"), _verbs(batch, q, "numpy")):
        np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
def test_sharded_publish_reuploads_only_dirty_shards(cuda_device):
    """A publish replaces the device form of the dirty shard alone; clean
    shards keep their tensors, and retired generations are freed."""
    import gc

    from repro_torch.index import ShardedIndexService
    keys = _dup_keys(200_000, seed=6)
    svc = ShardedIndexService(keys, error=64, n_shards=4, buffer_size=16,
                              assume_sorted=True)
    svc.search(keys[:8])
    base = torch.cuda.memory_allocated()
    for cycle in range(6):
        d = cycle % 4
        before = [h.current().table._device_cache[cuda_device]
                  for h in svc.handles]
        lo = svc.boundaries[d]
        for k in np.arange(8) + lo:
            svc.insert(float(k))
        assert sorted(svc.publish()) == [d]
        svc.search(keys[::1000])
        after = [h.current().table._device_cache[cuda_device]
                 for h in svc.handles]
        assert [a is not b for a, b in zip(after, before)] == \
            [s == d for s in range(4)]
        del before, after           # the retired generation's last holders
        gc.collect()
        torch.cuda.synchronize()
        # the replaced shard's old tensors are gone: only a few inserted
        # keys' worth of growth remains
        assert torch.cuda.memory_allocated() - base < 64 * 1024


@pytest.mark.gpu
def test_a_nine_shard_read_is_one_fused_launch_on_the_card(cuda_device):
    """Every read verb of a nine-shard service is one launch of the fused
    search over the view's table, equal to the host numpy backend and
    ``np.searchsorted``; a one-shard publish re-uploads that shard alone
    (the others keep their ``data_ptr``) and the next read, still one
    launch, assembles the new view on the card."""
    from repro_torch.index import ShardedIndexService
    keys = _dup_keys(300_000, seed=15)
    svc = ShardedIndexService(keys, error=64, n_shards=9, buffer_size=16,
                              assume_sorted=True)
    rng = np.random.default_rng(16)
    merged = keys
    for step in range(2):
        q = _queries(merged, rng, 100_000)
        reads = {"left": lambda: svc.search(q, "left"),
                 "right": lambda: svc.search(q, "right"),
                 "lookup": lambda: svc.lookup(q)}
        for name, read in reads.items():
            launches = fl.fitting_search_cuda.launches
            got = read()
            assert fl.fitting_search_cuda.launches == launches + 1, name
            want = (svc.lookup(q, "numpy") if name == "lookup" else
                    svc.search(q, name, "numpy"))
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(svc.search(q, "left"),
                                      np.searchsorted(merged, q, "left"))
        if step == 0:
            before = [h.current().table._device_cache[cuda_device]
                      for h in svc.handles]
            new = np.arange(8) + svc.boundaries[4] + 0.5
            svc.insert_many(new)
            assert sorted(svc.publish()) == [4]
            merged = np.sort(np.concatenate([keys, new]))
    after = [h.current().table._device_cache[cuda_device]
             for h in svc.handles]
    assert [a is not b for a, b in zip(after, before)] == \
        [d == 4 for d in range(9)]
    assert all(a.keys.data_ptr() == b.keys.data_ptr()
               for d, (a, b) in enumerate(zip(after, before)) if d != 4)
    view = svc._view[2].current().table._device_cache[cuda_device]
    assert view.keys.numel() == merged.size and view.base.dtype == torch.int32


@pytest.mark.gpu
def test_index_service_dispatch_and_calibration_on_the_card(cuda_device):
    """IndexService serves on the card by default; dispatch takes the cost
    model's thresholds; calibrate_device measures positive params."""
    from repro_torch.core.cost_model import calibrate_device
    from repro_torch.serve import IndexService
    keys = _dup_keys(40_000, seed=8)
    svc = IndexService(keys, error=32, buffer_size=8, assume_sorted=True)
    assert svc.default_backend == "cuda"
    q = _queries(keys, np.random.default_rng(9), 3_000)
    for side in ("left", "right"):
        np.testing.assert_array_equal(svc.search(q, side),
                                      np.searchsorted(keys, q, side))
        np.testing.assert_array_equal(svc.search(q, side, "dispatch"),
                                      np.searchsorted(keys, q, side))
    eng = svc.handle.engine("dispatch")
    assert 0 <= eng.small_max < eng.large_min
    cpu, gpu = calibrate_device(keys, device=cuda_device)
    assert cpu.c_ns > 0 and gpu.setup_ns > 0 and gpu.hbm_gbps > 0


# ------------------------------------------ LSM and the front door on the card
@pytest.mark.gpu
def test_lsm_on_the_card_matches_its_numpy_backend_and_the_oracle(
        cuda_device):
    """Spills, deletes, upserts and a compaction on the cuda backend: every
    run's device form lives on the card, each verb gives the host numpy
    backend's answer and ``np.searchsorted`` on the live multiset, and each
    run costs one fused launch per search."""
    from repro_torch.index import LsmIndexService
    keys = _dup_keys(60_000, seed=10)
    svc = LsmIndexService(keys, error=32, memtable_capacity=512,
                          level_fanout=4, assume_sorted=True)
    assert svc.default_backend == "cuda"
    rng = np.random.default_rng(11)
    ins = rng.integers(0, 20_000, 9 * 512).astype(np.float64)
    svc.insert_many(ins)
    dels = np.unique(keys[::997])
    for k in dels:
        svc.delete(float(k))
    ups = keys[5::1999]
    for k in ups:
        svc.upsert(float(k))
    svc.spill()
    assert svc.compact(max_steps=8) >= 4
    live = np.concatenate([keys, ins])
    live = np.sort(np.concatenate([live[~np.isin(live, np.concatenate(
        [dels, ups]))], np.unique(ups)]))
    assert svc.n_live_keys() == live.size
    for run in svc.level_set.runs:
        assert cuda_device in run.snapshot.table._device_cache
    q = _queries(live, rng, 5_000)
    for side in ("left", "right"):
        before = fl.fitting_search_cuda.launches
        got = svc.search(q, side)
        assert fl.fitting_search_cuda.launches - before == sum(
            r.n_keys > 0 for r in svc.level_set.runs)
        np.testing.assert_array_equal(got, svc.search(q, side, "numpy"))
        np.testing.assert_array_equal(got, np.searchsorted(live, q, side))
    for x in q[:40]:
        x = float(x)
        for verb in ("point", "predecessor", "successor"):
            assert getattr(svc, verb)(x) == getattr(svc, verb)(x, "numpy")
        assert svc.count(x, x + 50) == svc.count(x, x + 50, "numpy")
        np.testing.assert_array_equal(svc.range(x, x + 50).keys,
                                      svc.range(x, x + 50, "numpy").keys)


@pytest.mark.gpu
def test_pipeline_on_the_card_launches_the_fused_kernel(cuda_device):
    """Concurrent callers through ``AsyncIndexService`` over a cuda
    ``IndexService``: answers equal ``np.searchsorted`` and the flushes
    launch the fused kernel."""
    import threading

    from repro_torch.serve import AsyncIndexService, IndexService
    keys = _dup_keys(100_000, seed=12)
    svc = IndexService(keys, error=64, assume_sorted=True)
    failures = []
    fl.fitting_search_cuda.launches = 0
    with AsyncIndexService(svc, flush_threshold=256,
                           max_wait_us=500.0) as pipe:
        def caller(seed):
            r = np.random.default_rng(seed)
            for _ in range(64):
                q = _queries(keys, r, 40)[:int(r.integers(1, 40))]
                side = ("left", "right")[int(r.integers(2))]
                got = pipe.search(q, side, timeout=60.0)
                if not np.array_equal(got, np.searchsorted(keys, q, side)):
                    failures.append(seed)

        threads = [threading.Thread(target=caller, args=(s,))
                   for s in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120.0)
        assert not any(t.is_alive() for t in threads)
        flushes = pipe.metrics().pipeline.flushes
    assert not failures
    assert flushes > 0 and fl.fitting_search_cuda.launches > 0


# ------------------------------------------------ the device plane on the card
@pytest.mark.gpu
@pytest.mark.parametrize("exchange", ["allgather", "a2a"])
def test_device_plane_on_the_card_launches_one_search_a_row(cuda_device,
                                                            exchange):
    """Four rows on one card: every search equals ``np.searchsorted``, each
    row's search is one launch of the fused kernel (a2a's overflow pass
    adds a round), and a one-row publish keeps the clean rows' storage."""
    from repro_torch.index import DeviceShardedService
    keys = _dup_keys(80_000, seed=13)
    dev = str(cuda_device)
    svc = DeviceShardedService(keys, error=64, device_count=4,
                               devices=[dev] * 4, buffer_size=16,
                               exchange=exchange, assume_sorted=True)
    assert all(t.is_cuda for t in svc.device_set.d_keys)
    q = _queries(keys, np.random.default_rng(14), 40_000)
    fl.fitting_search_cuda.launches = 0
    for side in ("left", "right"):
        np.testing.assert_array_equal(svc.search(q, side),
                                      np.searchsorted(keys, q, side))
    launches = fl.fitting_search_cuda.launches
    if svc.metrics().device.a2a_overflow_queries == 0:
        assert launches == 4 * 2
    else:
        assert 4 * 2 < launches <= 4 * 2 * 2
    before = [t.data_ptr() for t in svc.device_set.d_keys]
    svc.insert(float(keys[0]) + 0.5)
    svc.publish()
    after = [t.data_ptr() for t in svc.device_set.d_keys]
    assert [a != b for a, b in zip(after, before)] == [True] + [False] * 3
    merged = np.sort(np.append(keys, keys[0] + 0.5))
    np.testing.assert_array_equal(svc.search(q), np.searchsorted(merged, q))


# ------------------------------------------------ the attention families

@pytest.mark.gpu
@pytest.mark.parametrize("hd,dtype", [(64, torch.bfloat16),
                                      (128, torch.bfloat16),
                                      (256, torch.bfloat16),
                                      (64, torch.float32),
                                      (128, torch.float32)])
def test_flash_more_queries_than_keys_non_causal(cuda_device, hd, dtype):
    """Cross-attention of a long prompt over fewer memory frames: Tq > S,
    so q_offset = S - Tq is negative, which non-causal attention must
    ignore (the wgmma path at bf16 hd 64 to 256, the CUDA-core one in
    f32)."""
    q, k, v = _qkv(cuda_device, 2, 8, 2, 700, 300, hd, dtype, seed=hd + 7)
    before = fa.flash_attention_cuda.launches
    got = fa.flash_attention_cuda(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert fa.flash_attention_cuda.launches == before + 1
    want = fa.flash_attention_torch(q, k, v, causal=False)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
def test_attend_prefill_brings_mixed_types_to_one(cuda_device):
    """A bf16 decoder query over keys and values projected from f32 memory:
    ``_attend_prefill`` hands the kernel f32 (the CUDA-core path) and
    returns f32, as the reference computes its dense attention."""
    from repro_torch.configs import get_config
    from repro_torch.models import blocks
    cfg = get_config("llama-3.2-vision-11b")
    g = torch.Generator(device=cuda_device).manual_seed(21)
    q = torch.randn((1, 300, 32, 128), generator=g,
                    device=cuda_device).to(torch.bfloat16)
    k, v = (torch.randn((1, 160, 8, 128), generator=g, device=cuda_device)
            for _ in range(2))
    before = fa.flash_attention_cuda.launches
    got = blocks._attend_prefill(q, k, v, cfg, causal=False, window=None)
    torch.cuda.synchronize()
    assert fa.flash_attention_cuda.launches == before + 1
    want = blocks._attend_dense(q, k, v, torch.ones(
        (300, 160), dtype=torch.bool, device=cuda_device), cfg)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


def _to(tree, dev):
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return [_to(v, dev) for v in tree]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", [
    "gemma3-12b", "internlm2-1.8b", "gemma2-27b", "minicpm-2b",
    "arctic-480b", "qwen3-moe-235b-a22b", "llama-3.2-vision-11b",
    "whisper-medium"])
def test_reduced_forward_on_the_card_matches_the_cpu(cuda_device, arch):
    """Each new family, reduced, in f32: the forward on the card (flash on
    its CUDA-core kernel at hd 16, MoE dispatch in torch ops) equals the
    same forward on the CPU (the kernel's plain twin) within flash's f32
    tolerance; prefill attention launched the kernel."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import forward, init_params
    cfg = reduced(get_config(arch))
    params = init_params(cfg, seed=5, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(6)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 40)).astype(
        np.int32))
    mem = None
    if cfg.memory_len:
        mem = torch.from_numpy((rng.standard_normal(
            (2, cfg.memory_len, cfg.d_model)) * 0.02).astype(np.float32))
    want, _ = forward(params, cfg, toks, memory=mem)
    before = fa.flash_attention_cuda.launches
    got, _ = forward(_to(params, cuda_device), cfg, toks.to(cuda_device),
                     memory=None if mem is None else mem.to(cuda_device))
    torch.cuda.synchronize()
    assert fa.flash_attention_cuda.launches > before
    torch.testing.assert_close(got.cpu(), want, rtol=2e-4, atol=2e-4)


def _bwd_inputs(device, b, t, w, offset=0):
    """g, a, h for the backward on the card (h the forward scan's states),
    each ``offset`` floats into its storage."""
    u, a, _ = _scan_inputs(device, b, t, w, False, offset)
    gen = torch.Generator(device=device).manual_seed(b + t + w)
    g = torch.randn(offset + b * t * w, generator=gen, device=device)
    h = torch.empty(offset + b * t * w, device=device)
    h[offset:] = rs.rglru_scan_torch(u, a)[0].flatten()
    return g[offset:].view(b, t, w), a, h[offset:].view(b, t, w)


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,w,offset,path", [
    (2, 300, 256, 0, "tma"), (2, 77, 130, 0, "unaligned"),
    (2, 37, 64, 0, "tma"), (3, 64, 128, 0, "tma"), (2, 1, 128, 0, "tma"),
    (1, 1, 130, 0, "unaligned"), (2, 200, 100, 0, "tma"),
    (2, 300, 64, 1, "unaligned")])
def test_rglru_backward_kernel_matches_twin(cuda_device, b, t, w, offset,
                                            path):
    """The backward kernel equals its twin bit for bit on both paths: T
    below one tile, T 1, a W that leaves the last channel tile partial
    (W 100), and a base off 16-byte alignment that forces unaligned; one
    launch, counted on the path scan_path names."""
    g, a, h = _bwd_inputs(cuda_device, b, t, w, offset)
    assert rs.scan_path(g, a, h) == path
    before = dict(rs.rglru_scan_backward_cuda.launches_by_path)
    fwd = rs.rglru_scan_cuda.launches
    du, da = rs.rglru_scan_backward_cuda(g, a, h)
    torch.cuda.synchronize()
    assert rs.rglru_scan_backward_cuda.launches_by_path == {
        p: n + (p == path) for p, n in before.items()}
    assert rs.rglru_scan_cuda.launches == fwd
    want_du, want_da = rs.rglru_scan_backward_torch(g, a, h)
    assert torch.equal(du, want_du) and torch.equal(da, want_da)


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,w", [(2, 300, 256), (2, 37, 64),
                                   (2, 200, 100)])
def test_rglru_backward_unaligned_kernel_equals_tma_kernel(cuda_device, b,
                                                           t, w):
    """The backward's two kernels on the same aligned inputs agree bit for
    bit."""
    g, a, h = _bwd_inputs(cuda_device, b, t, w)
    tma = rs._rglru_scan_backward_launch(g, a, h, "tma")
    old = rs._rglru_scan_backward_launch(g, a, h, "unaligned")
    torch.cuda.synchronize()
    assert torch.equal(tma[0], old[0]) and torch.equal(tma[1], old[1])


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,w", [(2, 300, 256), (2, 77, 130)])
def test_rglru_backward_on_the_card_equals_the_twin(cuda_device, b, t, w):
    """RGLRUScan's backward on the card is one launch of the backward
    kernel and none of the forward's; du and da equal the twin's backward
    on the same card, and the forward scan's twin on time-flipped inputs
    (the port's backward before its kernel), exactly (W 256 takes the tma
    path, W 130 the unaligned one)."""
    g = torch.Generator(device=cuda_device).manual_seed(b * t + w)
    u = torch.randn((b, t, w), generator=g, device=cuda_device)
    a = torch.rand((b, t, w), generator=g, device=cuda_device)
    dh = torch.randn((b, t, w), generator=g, device=cuda_device)
    tu, ta = u.clone().requires_grad_(True), a.clone().requires_grad_(True)
    h = rs.RGLRUScan.apply(tu, ta)
    before = (rs.rglru_scan_cuda.launches,
              rs.rglru_scan_backward_cuda.launches)
    h.backward(dh)
    torch.cuda.synchronize()
    assert (rs.rglru_scan_cuda.launches,
            rs.rglru_scan_backward_cuda.launches) == (before[0],
                                                      before[1] + 1)
    hh, _ = rs.rglru_scan_torch(u, a)
    want_du, want_da = rs.rglru_scan_backward_torch(dh, a, hh)
    assert torch.equal(tu.grad, want_du) and torch.equal(ta.grad, want_da)
    a_next = torch.cat([a[:, 1:], torch.ones_like(a[:, :1])], 1)
    rev, _ = rs.rglru_scan_torch(dh.flip(1).contiguous(),
                                 a_next.flip(1).contiguous())
    gacc = rev.flip(1)
    h_prev = torch.cat([torch.zeros_like(hh[:, :1]), hh[:, :-1]], 1)
    assert torch.equal(tu.grad, gacc)
    assert torch.equal(ta.grad, gacc * h_prev)


@pytest.mark.gpu
def test_rglru_empty_backward_counts_no_launch(cuda_device):
    """An empty batch, or an empty time axis in the backward, launches no
    kernel in either direction, so no counter moves: the launch itself
    counts."""
    u = torch.zeros((0, 5, 8), device=cuda_device, requires_grad=True)
    a = torch.zeros((0, 5, 8), device=cuda_device, requires_grad=True)
    before = (rs.rglru_scan_cuda.launches,
              rs.rglru_scan_backward_cuda.launches)
    rs.RGLRUScan.apply(u, a).sum().backward()
    empty = torch.zeros((2, 0, 8), device=cuda_device)
    du, da = rs.rglru_scan_backward_cuda(empty, empty, empty)
    torch.cuda.synchronize()
    assert u.grad.shape == a.grad.shape == (0, 5, 8)
    assert du.shape == da.shape == (2, 0, 8)
    assert (rs.rglru_scan_cuda.launches,
            rs.rglru_scan_backward_cuda.launches) == before


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["scan", "scan backward", "flash"])
def test_tma_kernels_launch_from_a_fresh_thread(cuda_device, kernel):
    """A TMA kernel whose launch is the first CUDA work of its thread (as
    in autograd's backward thread, or a caller's own thread): the launcher
    encodes its tensor maps once the runtime has made the card's context
    current there, and the result equals the same launch on this thread."""
    import threading
    if kernel == "flash":
        args = _qkv(cuda_device, 1, 4, 2, 130, 130, 128, torch.bfloat16, 3)
        fn = fa.flash_attention_cuda
    elif kernel == "scan":
        args = _scan_inputs(cuda_device, 2, 300, 256, True)
        fn = rs.rglru_scan_cuda
    else:
        args = _bwd_inputs(cuda_device, 2, 300, 256)
        fn = rs.rglru_scan_backward_cuda
    torch.cuda.synchronize()
    out = {}

    def run():
        try:
            out["got"] = fn(*args)
            torch.cuda.synchronize()
        except Exception as exc:          # raised below, on the test's thread
            out["error"] = exc

    worker = threading.Thread(target=run)
    worker.start()
    worker.join()
    if "error" in out:
        raise out["error"]
    want = fn(*args)
    torch.cuda.synchronize()
    for got, ref in zip(*(x if isinstance(x, tuple) else (x,)
                          for x in (out["got"], want))):
        assert torch.equal(got, ref)


@pytest.mark.gpu
def test_kernel_guards_refuse_grad_on_the_card(cuda_device):
    """Outside their autograd path flash and the scan refuse a CUDA input
    that requires grad while grad mode is on, and launch nothing."""
    x = torch.randn((1, 2, 8, 16), device=cuda_device, requires_grad=True)
    u = torch.randn((1, 8, 16), device=cuda_device, requires_grad=True)
    before = (fa.flash_attention_cuda.launches, rs.rglru_scan_cuda.launches)
    with pytest.raises(RuntimeError, match="requires grad"):
        fa.flash_attention(x, x, x)
    with pytest.raises(RuntimeError, match="requires grad"):
        rs.rglru_scan(u, u.detach().sigmoid())
    assert (fa.flash_attention_cuda.launches,
            rs.rglru_scan_cuda.launches) == before
    with torch.no_grad():
        fa.flash_attention(x, x, x)
        rs.rglru_scan(u, u.sigmoid())
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_train_step_on_the_card_matches_the_cpu(cuda_device):
    """One make_train_step of reduced recurrentgemma-9b in f32 on the card
    (the scan kernel forward and backward, attention through the chunked
    torch path) against the same step on the CPU: loss to 1e-4, the
    updated parameters close, the scan launched in both directions."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import init_params
    from repro_torch.train import AdamWConfig, init_opt_state, \
        make_train_step
    from repro_torch.tree import tree_leaves
    cfg = reduced(get_config("recurrentgemma-9b"))
    step = make_train_step(cfg, AdamWConfig(lr=3e-3, warmup_steps=1,
                                            total_steps=4))
    params = init_params(cfg, seed=2, dtype=torch.float32, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        2, cfg.vocab, (4, 33)).astype(np.int32))
    gpu_params = _to(params, cuda_device)     # before the step updates params
    want_p, _, want = step(params, init_opt_state(params), {"tokens": toks})
    before = (rs.rglru_scan_cuda.launches,
              rs.rglru_scan_backward_cuda.launches)
    got_p, _, got = step(gpu_params, init_opt_state(gpu_params),
                         {"tokens": toks.to(cuda_device)})
    torch.cuda.synchronize()
    fwd = rs.rglru_scan_cuda.launches - before[0]
    bwd = rs.rglru_scan_backward_cuda.launches - before[1]
    n_rglru = sum(r * u.count("rglru") for u, r in cfg.stacks)
    assert bwd == n_rglru and fwd == 2 * n_rglru   # remat recomputes
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-4, atol=1e-4)
    for g, w in zip(tree_leaves(got_p), tree_leaves(want_p)):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-3, atol=1e-4)


# ------------------------------------------------ the batched ShrinkingCone
def _bits(t):
    return t.cpu().view(torch.int64)


def _cone_on_card(keys, off, error, mode, dev):
    from repro_torch.kernels import shrinking_cone as sc
    want = sc.shrinking_cone_runs_torch(torch.from_numpy(keys), off, error,
                                        mode)
    before = sc.shrinking_cone_runs_cuda.launches
    got = sc.shrinking_cone_runs(torch.from_numpy(keys).to(dev), off, error,
                                 mode)
    torch.cuda.synchronize()
    assert sc.shrinking_cone_runs_cuda.launches == before + 1
    assert got[0].is_cuda and torch.equal(got[0].cpu(), want[0])
    if mode == "clamped":
        assert torch.equal(_bits(got[1]), _bits(want[1]))
    else:
        assert got[1] is None and want[1] is None


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["paper", "clamped"])
@pytest.mark.parametrize("case", ["short runs", "all duplicates",
                                  "subnormal spans", "past a warp",
                                  "past 1e5", "error 0"])
def test_shrinking_cone_kernel_matches_twin_bit_for_bit(cuda_device, case,
                                                        mode):
    from _cone_cases import cone_cases
    _cone_on_card(*cone_cases()[case], mode, cuda_device)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["paper", "clamped"])
def test_shrinking_cone_kernel_on_a_weblogs_shards_dirty_runs(cuda_device,
                                                              mode):
    """A shard of 2^20 Weblogs-shaped keys with 2,000 buffered inserts: the
    kernel fits its hundreds of dirty runs as the twin does."""
    from _cone_cases import weblogs_tree
    tree = weblogs_tree(2 ** 20, 2000, seed=4, mode=mode)
    dirty = tree.dirty_segments()
    assert len(dirty) > 300
    merged, _, off = tree._merge_dirty(dirty)
    _cone_on_card(merged, off, tree.err_seg, mode, cuda_device)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["paper", "clamped"])
def test_flush_on_the_card_launches_once_and_equals_the_host(cuda_device,
                                                             mode):
    import copy

    from _cone_cases import weblogs_tree
    from repro_torch.kernels import shrinking_cone as sc
    card = weblogs_tree(2 ** 17, 400, seed=5, mode=mode)
    host = copy.deepcopy(card)
    before = sc.shrinking_cone_runs_cuda.launches
    n = card.flush(cuda_device)
    assert n == host.flush() > 0
    assert sc.shrinking_cone_runs_cuda.launches == before + 1
    assert card.flush(cuda_device) == 0          # nothing dirty: no launch
    assert sc.shrinking_cone_runs_cuda.launches == before + 1
    assert torch.equal(_bits(torch.from_numpy(card.slopes)),
                       _bits(torch.from_numpy(host.slopes)))
    np.testing.assert_array_equal(card.start_keys, host.start_keys)
    assert len(card.pages) == len(host.pages)
    assert all(np.array_equal(a, b) for a, b in zip(card.pages, host.pages))


@pytest.mark.gpu
def test_cuda_sharded_service_refits_on_the_card_as_numpy_on_the_host(
        cuda_device):
    """A ``cuda``-backend service publishes the tables of a ``numpy``-backend
    one after the same inserts, through a rebalance too; its flush rows say
    every re-fit ran on the card, the host's say none did."""
    from repro_torch.index import ShardedIndexService
    from repro_torch.index.telemetry import Monitor
    keys = _dup_keys(120_000, seed=12)
    kw = dict(error=64, n_shards=4, buffer_size=16, assume_sorted=True)
    card = ShardedIndexService(keys, monitor=Monitor(), **kw)
    host = ShardedIndexService(keys, backend="numpy", monitor=Monitor(),
                               **kw)
    assert all(p.device.type == "cuda" for p in card.publishers)
    rng = np.random.default_rng(13)
    for step in range(3):
        new = np.concatenate([keys[rng.integers(0, keys.size, 3000)],
                              np.round(rng.uniform(0, keys[-1], 1000))])
        for svc in (card, host):
            svc.insert_many(new)
            svc.publish()
            if step == 1:
                svc.rebalance(force=True)
        for a, b in zip(card.handles, host.handles):
            t, r = a.current().table, b.current().table
            for f in ("start_key", "slope", "base", "seg_end", "keys"):
                np.testing.assert_array_equal(getattr(t, f), getattr(r, f))
    rows = card.monitor.channel("span.tree.flush")
    assert rows[:, 2].sum() > 0 and np.array_equal(rows[:, 3], rows[:, 2])
    assert not host.monitor.channel("span.tree.flush")[:, 3].any()
