"""The port's LM kernels against the JAX package's Pallas kernels.

``flash_attention_torch`` and ``rglru_scan_torch`` (the plain twins that
the CUDA wrappers take for CPU tensors) are held against
``repro.kernels.flash_attention.flash_attention`` and
``repro.kernels.rglru_scan.rglru_scan_pallas`` in interpret mode, on every
case of ``tests/test_kernels_extra.py``, with that file's tolerances: f32
attention 2e-4 and bf16 2e-2 (the reference's own bounds for a blocked
against a dense softmax), the scan rtol 1e-5 / atol 1e-6.  Inputs are made
with numpy from a seed and handed to both.  The torch oracles of
``kernels/ref.py`` are held against the reference's, and the device
dispatch is checked: CPU tensors take the twin, a CUDA tensor never does.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as ref_flash
from repro.kernels.ref import attention_ref as ref_attention_ref
from repro.kernels.ref import rglru_ref as ref_rglru_ref
from repro.kernels.rglru_scan import rglru_scan_pallas
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rglru_scan as rs
from repro_torch.kernels.ref import (BLOCK_REL_TOL, attention_ref,
                                    block_rel_err, rglru_ref)


def _qkv(b, h, hkv, tq, s, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, tq, hd)).astype(np.float32),
            rng.normal(size=(b, hkv, s, hd)).astype(np.float32),
            rng.normal(size=(b, hkv, s, hd)).astype(np.float32))


def _both(arrays, dtype):
    """The same values as JAX arrays and as torch tensors of one type."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


FLASH_CASES = (
    [pytest.param((2, 4, 2, tq, s, 64), {"causal": causal}, "f32", 2e-4,
                  id=f"tq{tq}-s{s}-causal{causal}")
     for tq, s in [(128, 128), (256, 384), (100, 200)]
     for causal in (True, False)]
    + [pytest.param((1, 4, 4, 256, 256, 32),
                    {"causal": True, "window": 64, "softcap": 50.0}, "f32",
                    2e-4, id="window-softcap"),
       pytest.param((2, 8, 2, 1, 512, 64), {"causal": True}, "f32", 2e-4,
                    id="decode-one-query"),
       pytest.param((1, 2, 2, 128, 128, 64), {"causal": True}, "bf16", 2e-2,
                    id="bf16")])


@pytest.mark.parametrize("shape,kw,dtype,tol", FLASH_CASES)
def test_flash_twin_matches_pallas_kernel(shape, kw, dtype, tol):
    jx, tx = _both(_qkv(*shape, seed=sum(shape)), dtype)
    want = ref_flash(*jx, interpret=True, **kw)
    got = fa.flash_attention(*tx, **kw)
    assert got.dtype == tx[0].dtype and got.shape == tx[0].shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("b,t,w", [(2, 16, 128), (1, 100, 256), (3, 7, 384)])
def test_rglru_twin_matches_pallas_kernel(b, t, w):
    rng = np.random.default_rng(b + t)
    u = rng.normal(size=(b, t, w)).astype(np.float32)
    a = rng.uniform(0.3, 0.99, size=(b, t, w)).astype(np.float32)
    want, want_last = rglru_scan_pallas(jnp.asarray(u), jnp.asarray(a),
                                        interpret=True)
    got, got_last = rs.rglru_scan(torch.from_numpy(u), torch.from_numpy(a))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_last.numpy(), np.asarray(want_last),
                               rtol=1e-5, atol=1e-6)


def test_rglru_twin_initial_state_matches_pallas_kernel():
    rng = np.random.default_rng(0)
    u = rng.normal(size=(2, 8, 128)).astype(np.float32)
    a = rng.uniform(0.5, 0.9, size=(2, 8, 128)).astype(np.float32)
    h0 = rng.normal(size=(2, 128)).astype(np.float32)
    want, want_last = rglru_scan_pallas(jnp.asarray(u), jnp.asarray(a),
                                        jnp.asarray(h0), interpret=True)
    got, got_last = rs.rglru_scan(torch.from_numpy(u), torch.from_numpy(a),
                                  torch.from_numpy(h0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_last.numpy(), np.asarray(want_last),
                               rtol=1e-5, atol=1e-6)


def test_rglru_twin_takes_any_width():
    """W = 64 (the reduced config's width): the Pallas kernel's
    W % 128 == 0 is a TPU tiling limit the port does not keep."""
    rng = np.random.default_rng(3)
    u = torch.from_numpy(rng.normal(size=(2, 5, 64)).astype(np.float32))
    a = torch.from_numpy(rng.uniform(0.1, 0.9, (2, 5, 64)).astype(np.float32))
    h, last = rs.rglru_scan(u, a)
    want = torch.zeros(2, 64)
    for t in range(5):
        want = a[:, t] * want + u[:, t]
        assert torch.equal(h[:, t], want)
    assert torch.equal(last, want)


@pytest.mark.parametrize("kw", [{"causal": True},
                                {"causal": False, "window": 16},
                                {"causal": True, "window": 8,
                                 "softcap": 30.0}])
def test_attention_ref_matches_reference_oracle(kw):
    jx, tx = _both(_qkv(2, 3, 3, 40, 56, 32, seed=11), "f32")
    want = ref_attention_ref(*jx, **kw)
    got = attention_ref(*tx, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_rglru_ref_matches_reference_oracle():
    rng = np.random.default_rng(4)
    x, gx, ga = (rng.normal(size=(2, 9, 48)).astype(np.float32)
                 for _ in range(3))
    a_log = rng.normal(size=(48,)).astype(np.float32)
    want = ref_rglru_ref(*(jnp.asarray(v) for v in (x, a_log, gx, ga)))
    got = rglru_ref(*(torch.from_numpy(v) for v in (x, a_log, gx, ga)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


def test_cpu_tensors_take_the_twins_without_counting():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 1, 8, 8, 16, seed=1))
    u, a = torch.rand(1, 4, 8), torch.rand(1, 4, 8)
    before = (fa.flash_attention_cuda.launches, rs.rglru_scan_cuda.launches)
    assert torch.equal(fa.flash_attention(q, k, v),
                       fa.flash_attention_torch(q, k, v))
    assert torch.equal(rs.rglru_scan(u, a)[0], rs.rglru_scan_torch(u, a)[0])
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rs.rglru_scan_cuda(u, a)
    assert (fa.flash_attention_cuda.launches,
            rs.rglru_scan_cuda.launches) == before


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to drive the dispatch."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _fake(t):
    return torch.Tensor._make_subclass(_FakeCuda, t)


def test_cuda_tensors_never_take_the_twins(monkeypatch):
    def twin(*args, **kw):
        raise AssertionError("a CUDA tensor took the plain twin")

    def no_library():
        raise RuntimeError("kernel library unavailable")

    for mod, name in ((fa, "flash_attention_torch"),
                      (rs, "rglru_scan_torch")):
        monkeypatch.setattr(mod, name, twin)
        monkeypatch.setattr(mod, "_library", no_library)
    q, k, v = (_fake(torch.from_numpy(a))
               for a in _qkv(1, 2, 1, 8, 8, 16, seed=2))
    with pytest.raises(RuntimeError, match="library unavailable"):
        fa.flash_attention(q, k, v)
    with pytest.raises(RuntimeError, match="library unavailable"):
        rs.rglru_scan(_fake(torch.rand(1, 4, 8)), _fake(torch.rand(1, 4, 8)))


def _scan_view(t, w, offset=0, b=2):
    """A contiguous (b, t, w) f32 view starting ``offset`` floats into its
    storage (the storage itself is 64-byte aligned)."""
    flat = torch.zeros(offset + b * t * w)
    return flat[offset:].view(b, t, w)


@pytest.mark.parametrize("t,w,offset,path", [
    (16, 64, 0, "tma"), (16, 96, 0, "tma"), (3, 4, 0, "tma"),
    (1, 4096, 0, "tma"), (1000, 96, 0, "tma"), (16, 64, 4, "tma"),
    (16, 130, 0, "unaligned"), (16, 63, 0, "unaligned"),
    (37, 2, 0, "unaligned"), (16, 64, 1, "unaligned"),
    (16, 64, 2, "unaligned"), (0, 64, 0, "unaligned")])
def test_rglru_scan_path_by_width_base_and_length(t, w, offset, path):
    """TMA needs a 16-byte aligned base and row stride (W % 4 == 0) and a
    tensor map needs T > 0; every other input takes the unaligned kernel."""
    u = _scan_view(t, w, offset)
    assert rs.scan_path(u, _scan_view(t, w)) == path
    assert rs.scan_path(_scan_view(t, w), u) == path


def test_rglru_scan_path_reads_both_inputs():
    u, a = _scan_view(8, 64), _scan_view(8, 64, offset=1)
    assert rs.scan_path(u, u.clone()) == "tma"
    assert rs.scan_path(u, a) == rs.scan_path(a, u) == "unaligned"


def test_rglru_private_entry_refuses_tma_where_tma_cannot_read(monkeypatch):
    """The private entry may run the unaligned kernel on any input, but
    never the TMA kernel on one it cannot read; a bad path name raises.
    Neither reaches the library or a counter."""
    monkeypatch.setattr(rs, "_library", lambda: pytest.fail("launched"))
    before = (rs.rglru_scan_cuda.launches,
              dict(rs.rglru_scan_cuda.launches_by_path))
    for u in (_scan_view(8, 130), _scan_view(8, 64, offset=1),
              _scan_view(0, 64)):
        fake = _fake(u)
        with pytest.raises(ValueError, match="TMA kernel needs"):
            rs._rglru_scan_launch(fake, _fake(u.clone()), None, "tma")
    with pytest.raises(ValueError, match="path must be one of"):
        rs._rglru_scan_launch(_fake(_scan_view(8, 64)),
                              _fake(_scan_view(8, 64)), None, "chunked")
    with pytest.raises(ValueError, match="CUDA tensors"):
        rs._rglru_scan_launch(_scan_view(8, 64), _scan_view(8, 64), None,
                              "unaligned")
    assert (rs.rglru_scan_cuda.launches,
            rs.rglru_scan_cuda.launches_by_path) == before


def test_rglru_backward_cuda_tensors_never_take_the_twin(monkeypatch):
    """The backward's dispatcher: a CPU tensor takes the twin without a
    count, a CUDA tensor the kernel (here: no library, so it raises) and
    never the twin."""
    g, a, h = (torch.rand(1, 4, 8) for _ in range(3))
    before = (rs.rglru_scan_backward_cuda.launches,
              rs.rglru_scan_cuda.launches)
    got = rs.rglru_scan_backward(g, a, h)
    want = rs.rglru_scan_backward_torch(g, a, h)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="CUDA tensors"):
        rs.rglru_scan_backward_cuda(g, a, h)
    assert (rs.rglru_scan_backward_cuda.launches,
            rs.rglru_scan_cuda.launches) == before

    def twin(*args, **kw):
        raise AssertionError("a CUDA tensor took the plain twin")

    def no_library():
        raise RuntimeError("kernel library unavailable")

    monkeypatch.setattr(rs, "rglru_scan_backward_torch", twin)
    monkeypatch.setattr(rs, "_library", no_library)
    with pytest.raises(RuntimeError, match="library unavailable"):
        rs.rglru_scan_backward(_fake(g), _fake(a), _fake(h))


@pytest.mark.parametrize("t,w,offset,which,path", [
    (16, 64, 0, None, "tma"), (1, 100, 0, None, "tma"),
    (16, 130, 0, None, "unaligned"), (16, 64, 1, 0, "unaligned"),
    (16, 64, 2, 1, "unaligned"), (16, 64, 3, 2, "unaligned"),
    (0, 64, 0, None, "unaligned")])
def test_rglru_backward_path_reads_g_a_and_h(t, w, offset, which, path):
    """The backward takes the TMA kernel only where TMA can read g, a and
    h alike; one misaligned base among them sends it to the unaligned
    kernel, and the private entry refuses TMA there without launching."""
    views = [_scan_view(t, w, offset if i == which else 0) for i in range(3)]
    assert rs.scan_path(*views) == path
    if path == "unaligned":
        before = dict(rs.rglru_scan_backward_cuda.launches_by_path)
        fakes = [_fake(v) for v in views]
        with pytest.raises(ValueError, match="TMA kernel needs"):
            rs._rglru_scan_backward_launch(*fakes, "tma")
        with pytest.raises(ValueError, match="path must be one of"):
            rs._rglru_scan_backward_launch(*fakes, "flipped")
        assert rs.rglru_scan_backward_cuda.launches_by_path == before


@pytest.mark.parametrize("bad", ["dtype", "gqa", "causal-long-q", "window",
                                 "zero-keys"])
def test_flash_wrapper_rejects_bad_inputs(bad):
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 4, 2, 8, 8, 16, seed=3))
    kw = {"causal": True}
    if bad == "dtype":
        k = k.double()
    elif bad == "gqa":
        q = q[:, :3]
    elif bad == "causal-long-q":
        k, v = k[:, :, :4], v[:, :, :4]
    elif bad == "window":
        kw["window"] = 0
    else:
        k, v = k[:, :, :0], v[:, :, :0]
        kw["causal"] = False
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v, **kw)


def test_flash_cuda_wrapper_rejects_unsupported_head_dim(monkeypatch):
    monkeypatch.setattr(fa, "_library", lambda: None)
    q, k, v = (_fake(torch.from_numpy(a))
               for a in _qkv(1, 2, 1, 4, 4, 48, seed=4))
    with pytest.raises(ValueError, match="head dim 48"):
        fa.flash_attention(q, k, v)


@pytest.mark.parametrize("dtype,hd,path", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 256, "wgmma"), (torch.bfloat16, 16, "cuda-core"),
    (torch.bfloat16, 32, "cuda-core"), (torch.float32, 64, "cuda-core"),
    (torch.float32, 256, "cuda-core"), (torch.float32, 16, "cuda-core")])
def test_flash_kernel_path_by_dtype_and_head_dim(dtype, hd, path):
    assert fa.kernel_path(dtype, hd) == path


def _views(dtype, hd, bad):
    """q, k, v as (B, H, T, hd) views of (B, T, H, hd) buffers, one of them
    broken for TMA where ``bad`` says so."""
    x = torch.zeros(1, 8, 3, hd + (4 if bad == "stride" else 0), dtype=dtype)
    q = x[..., :hd].transpose(1, 2)
    if bad == "base":
        flat = torch.zeros(1 + 8 * 3 * hd, dtype=dtype)[1:]
        q = flat.view(1, 8, 3, hd).transpose(1, 2)
    kv = torch.zeros(1, 8, 1, hd, dtype=dtype).transpose(1, 2)
    return q, kv, kv


@pytest.mark.parametrize("bad,match", [("base", "16-byte aligned"),
                                       ("stride", "multiples of 16 bytes")])
def test_flash_wgmma_path_raises_on_views_tma_cannot_take(bad, match):
    q, k, v = _views(torch.bfloat16, 64, bad)
    before = fa.flash_attention_cuda.launches
    with pytest.raises(ValueError, match=match):
        fa.flash_attention_cuda(q, k, v)
    # the same view in f32 goes to the CUDA-core kernel, which takes it
    q, k, v = _views(torch.float32, 64, bad)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_cuda(q, k, v)
    assert fa.flash_attention_cuda.launches == before


def test_flash_wgmma_path_takes_aligned_views_and_ignores_unit_axes():
    """A view TMA can take passes the checks (and reaches the device check
    on the CPU); an axis of size 1 may carry any stride."""
    q, k, v = _views(torch.bfloat16, 128, None)
    q = torch.as_strided(q, q.shape, (7,) + q.stride()[1:])   # B = 1
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_cuda(q, k, v)


def _masked_attention(q, k, v, mask, round_p):
    """Masked softmax attention the way a tensor-core kernel rounds it
    (``round_p``: the unnormalised probabilities to bf16 before P V), the
    output in q's type."""
    logits = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float())
    logits = torch.where(mask, logits * q.shape[-1] ** -0.5, -1e30)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    norm = p.sum(-1, keepdim=True)
    if round_p:
        p = p.to(torch.bfloat16).float()
    return (torch.einsum("bhts,bhsd->bhtd", p, v.float()) / norm).to(q.dtype)


@pytest.mark.parametrize("fault", [None, "window-edge", "dropped-tile"])
def test_block_error_limit_separates_rounding_from_mask_faults(fault):
    """The bf16 limit of ``block_rel_err`` admits the tensor-core kernel's
    rounding of P and O and rejects a window edge off by one key, or one
    64-key tile dropped from each block of query rows."""
    t, window = 1024, 512
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(1, 2, 2, t, t, 128, seed=9))
    want = fa.flash_attention_torch(q, k, v, causal=True, window=window)
    qpos = torch.arange(t)[:, None]
    kpos = torch.arange(t)[None, :]
    mask = (kpos <= qpos) & (kpos > qpos - window)
    if fault == "window-edge":
        mask = (kpos <= qpos) & (kpos > qpos - window - 1)
    elif fault == "dropped-tile":
        mask &= kpos // 64 != qpos // 64 - 3
    err = block_rel_err(_masked_attention(q, k, v, mask, round_p=True), want)
    if fault is None:
        assert err < BLOCK_REL_TOL[torch.bfloat16]
    else:
        assert err > BLOCK_REL_TOL[torch.bfloat16]
