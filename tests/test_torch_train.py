"""The port's training against the JAX package on the CPU: the RG-LRU
scan's custom VJP (``RGLRUScan``) against ``jax.grad`` of the reference's
``_rglru_scan``; the kernels' guards against a dropped gradient; AdamW and
int8 error-feedback compression on identical numpy inputs; and three
steps of
``make_train_step`` (plain, two microbatches, compressed) from the same
parameters and optimizer state (``opt_state_from_jax``) as the reference's
``make_train_step`` called with no mesh."""
import types

import _torch_archs as P
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.blocks import _rglru_scan as ref_rglru_scan
from repro.train.compress import compress_decompress as ref_compress
from repro.train.compress import init_residual as ref_init_residual
from repro.train.optimizer import AdamWConfig as RefAdamWConfig
from repro.train.optimizer import adamw_update as ref_adamw_update
from repro.train.optimizer import init_opt_state as ref_init_opt_state
from repro.train.step import make_train_step as ref_make_train_step
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rglru_scan as rs
from repro_torch.models import opt_state_from_jax, params_from_jax
from repro_torch.train import (AdamWConfig, adamw_update,
                               compress_decompress, init_residual,
                               make_train_step)
from repro_torch.tree import tree_leaves

CPU = "cpu"
T1 = P.TRAIN_T1


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ------------------------------------------------------------------ the scan
@pytest.mark.parametrize("shape", [(2, 9, 6), (1, 33, 4), (3, 1, 5)])
def test_rglru_scan_grads_match_reference(shape):
    rng = np.random.default_rng(sum(shape))
    u = rng.standard_normal(shape).astype(np.float32)
    a = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    w = rng.standard_normal(shape).astype(np.float32)   # d loss / d h

    def ref(u, a):
        return jnp.sum(ref_rglru_scan(u, a) * w)

    want_du, want_da = jax.grad(ref, argnums=(0, 1))(jnp.asarray(u),
                                                     jnp.asarray(a))
    tu = torch.from_numpy(u).requires_grad_(True)
    ta = torch.from_numpy(a).requires_grad_(True)
    h = rs.RGLRUScan.apply(tu, ta)
    torch.sum(h * torch.from_numpy(w)).backward()
    np.testing.assert_allclose(h.detach().numpy(),
                               np.asarray(ref_rglru_scan(u, a)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tu.grad.numpy(), np.asarray(want_du),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(want_da),
                               rtol=1e-5, atol=1e-6)


def test_rglru_scan_backward_is_the_twin_on_flipped_time():
    """RGLRUScan's backward on the CPU is the reverse recurrence written
    out step by step, bit for bit."""
    rng = np.random.default_rng(4)
    u = torch.from_numpy(rng.standard_normal((2, 11, 8)).astype(np.float32))
    a = torch.from_numpy(rng.uniform(0, 1, (2, 11, 8)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 11, 8)).astype(np.float32))
    tu, ta = u.clone().requires_grad_(True), a.clone().requires_grad_(True)
    rs.RGLRUScan.apply(tu, ta).backward(g)
    h, _ = rs.rglru_scan_torch(u, a)
    gacc = torch.zeros_like(g)
    acc = torch.zeros((2, 8))
    for t in reversed(range(11)):       # gacc_t = g_t + a_{t+1} gacc_{t+1}
        nxt = a[:, t + 1] if t + 1 < 11 else torch.ones((2, 8))
        acc = nxt * acc + g[:, t]
        gacc[:, t] = acc
    h_prev = torch.cat([torch.zeros((2, 1, 8)), h[:, :-1]], 1)
    assert torch.equal(tu.grad, gacc)
    assert torch.equal(ta.grad, gacc * h_prev)


def _flip_backward(g, a, h):
    """The port's backward before its own kernel: the forward scan's twin
    on time-flipped g and a_next, flipped back; da = gacc * h_prev."""
    a_next = torch.cat([a[:, 1:], torch.ones_like(a[:, :1])], 1)
    rev, _ = rs.rglru_scan_torch(g.flip(1).contiguous(),
                                 a_next.flip(1).contiguous())
    gacc = rev.flip(1)
    h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], 1)
    return gacc, gacc * h_prev


def _shifted_backward(g, a, h):
    """The backward as the TMA kernel reads it: a shifted one step later
    and h one step earlier, the rows outside [0, T) read as 0 (a zero-fill
    box). So a_T is 0 here where the twin takes 1; bit-equal all the same,
    since gacc_T = +0 and 0 * (+0) = 1 * (+0) = +0."""
    b, t, w = g.shape
    a_next = torch.cat([a[:, 1:], torch.zeros((b, min(t, 1), w))], 1)
    h_prev = torch.cat([torch.zeros((b, min(t, 1), w)), h[:, :-1]], 1)
    du, acc = torch.empty_like(g), torch.zeros((b, w))
    for i in reversed(range(t)):
        acc = a_next[:, i] * acc + g[:, i]
        du[:, i] = acc
    return du, du * h_prev


@pytest.mark.parametrize("shape", [(2, 1, 8), (2, 64, 8), (2, 65, 8),
                                   (2, 300, 8), (3, 17, 5), (0, 7, 8),
                                   (2, 0, 8)])
def test_rglru_scan_backward_twin_equals_flip_composition(shape):
    """The backward's twin (a loop over time downward, the kernel's
    rounding) equals the flip-based composition the port ran before its
    backward kernel, and the kernel's reading with a_T = 0, torch.equal;
    empty shapes give empty outputs."""
    rng = np.random.default_rng(sum(shape) + 1)
    u, g = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for _ in range(2))
    a = torch.from_numpy(rng.uniform(0.0, 1.0, shape).astype(np.float32))
    h, _ = rs.rglru_scan_torch(u, a)
    du, da = rs.rglru_scan_backward_torch(g, a, h)
    assert du.shape == da.shape == shape
    for want_du, want_da in (_flip_backward(g, a, h),
                             _shifted_backward(g, a, h)):
        assert torch.equal(du, want_du) and torch.equal(da, want_da)
    tu, ta = u.clone().requires_grad_(True), a.clone().requires_grad_(True)
    rs.RGLRUScan.apply(tu, ta).backward(g)
    assert torch.equal(tu.grad, du) and torch.equal(ta.grad, da)


def test_rglru_scan_backward_op_on_meta_counts_no_flops():
    """The registered backward gives the shapes on meta, and a flop counter
    sees it (0 flops, as the forward's op) where autograd runs it."""
    from torch.utils.flop_counter import FlopCounterMode
    m = torch.empty((2, 9, 6), device="meta")
    du, da = rs.rglru_scan_backward(m, m, m)
    assert du.device.type == da.device.type == "meta"
    assert du.shape == da.shape == (2, 9, 6)
    tu = torch.rand((2, 9, 6), requires_grad=True)
    ta = torch.rand((2, 9, 6), requires_grad=True)
    with FlopCounterMode(display=False) as fc:
        rs.RGLRUScan.apply(tu, ta).sum().backward()
    counts = fc.get_flop_counts()["Global"]
    assert counts[torch.ops.repro_torch.rglru_scan_backward] == 0
    assert fc.get_total_flops() == 0
    with pytest.raises(ValueError, match="must share shape"):
        rs.rglru_scan_backward(m, m, torch.empty((2, 8, 6), device="meta"))


def _fake_cuda(requires_grad=True):
    """Stands for a CUDA tensor where there is no card: the guards read
    only ``device`` and ``requires_grad``, before any kernel is touched."""
    return types.SimpleNamespace(device=torch.device("cuda"),
                                 requires_grad=requires_grad)


@pytest.mark.parametrize("call", ["rglru_scan", "flash_attention"])
def test_kernels_refuse_a_cuda_tensor_that_requires_grad(call, monkeypatch):
    """Outside their autograd path both dispatchers raise on a CUDA input
    that requires grad while grad mode is on (their kernels would give the
    output no grad_fn); under no_grad, or without requires_grad, they go
    on to the kernel (stubbed here)."""
    launched = []
    if call == "rglru_scan":
        monkeypatch.setattr(rs, "rglru_scan_cuda",
                            lambda *a, **k: launched.append(a))
        fn = lambda x: rs.rglru_scan(x, x)            # noqa: E731
    else:
        monkeypatch.setattr(fa, "flash_attention_cuda",
                            lambda *a, **k: launched.append(a))
        fn = lambda x: fa.flash_attention(x, x, x)    # noqa: E731
    with pytest.raises(RuntimeError, match="requires grad"):
        fn(_fake_cuda())
    assert not launched
    with torch.no_grad():
        fn(_fake_cuda())
    fn(_fake_cuda(requires_grad=False))
    assert len(launched) == 2


# ------------------------------------------------------- optimizer, compress
def _rand_tree(rng, dtype=np.float32):
    return {"a": rng.standard_normal((5, 7)).astype(dtype),
            "b": {"c": rng.standard_normal((11,)).astype(dtype)}}


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


@pytest.mark.parametrize("schedule", ["cosine", "wsd", "const"])
def test_adamw_update_matches_reference(schedule):
    rng = np.random.default_rng(2)
    params, grads = _rand_tree(rng), _rand_tree(rng)
    m, v = _rand_tree(rng), _rand_tree(rng)
    v = jax.tree.map(np.abs, v)
    kw = dict(lr=3e-3, schedule=schedule, warmup_steps=4, total_steps=20,
              grad_clip=0.5)
    ref_state = {"m": m, "v": v, "step": jnp.asarray(6, jnp.int32)}
    state = {"m": _torch_tree(m), "v": _torch_tree(v),
             "step": torch.tensor(6, dtype=torch.int32)}
    want_p, want_s, want_m = ref_adamw_update(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, grads),
        ref_state, RefAdamWConfig(**kw))
    got_p, got_s, got_m = adamw_update(_torch_tree(params),
                                       _torch_tree(grads), state,
                                       AdamWConfig(**kw))
    for got, want in ((got_p, want_p), (got_s["m"], want_s["m"]),
                      (got_s["v"], want_s["v"])):
        for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)
    assert int(got_s["step"]) == int(want_s["step"]) == 7
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]),
                                   rtol=1e-6)


def test_compress_decompress_matches_reference():
    rng = np.random.default_rng(3)
    grads = _rand_tree(rng)
    ref_res, res = ref_init_residual(grads), init_residual(
        _torch_tree(grads))
    for _ in range(3):                  # the residual feeds the next call
        want, ref_res = ref_compress(jax.tree.map(jnp.asarray, grads),
                                     ref_res)
        got, res = compress_decompress(_torch_tree(grads), res)
        for g, w in zip(tree_leaves(got) + tree_leaves(res),
                        jax.tree.leaves(want) + jax.tree.leaves(ref_res)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "recurrentgemma-9b"])
@pytest.mark.parametrize("mode", ["plain", "microbatches", "compress"])
def test_train_steps_match_reference(arch, mode):
    """Three steps from the same parameters and optimizer state: the loss
    of each to 1e-4 (the reference's make_train_step with no mesh)."""
    cfg, ref_cfg, ref_params, _, _ = P.train_inputs(arch)
    mb = 2 if mode == "microbatches" else 1
    comp = mode == "compress"
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=10)
    ref_step = jax.jit(ref_make_train_step(ref_cfg, RefAdamWConfig(**kw),
                                           microbatches=mb, compress=comp))
    step = make_train_step(cfg, AdamWConfig(**kw), microbatches=mb,
                           compress=comp)
    ref_opt = ref_init_opt_state(ref_params)
    if comp:
        ref_opt["residual"] = ref_init_residual(ref_params)
    params = params_from_jax(_np(ref_params), cfg, CPU)
    opt = opt_state_from_jax(_np(ref_opt), cfg, CPU)
    rng = np.random.default_rng(5)
    for i in range(3):
        toks = rng.integers(2, cfg.vocab, size=(4, T1)).astype(np.int32)
        ref_params, ref_opt, want = ref_step(ref_params, ref_opt,
                                             {"tokens": jnp.asarray(toks)})
        params, opt, got = step(params, opt,
                                {"tokens": torch.from_numpy(toks)})
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                                   rtol=1e-4, atol=1e-4, err_msg=f"step {i}")
        np.testing.assert_allclose(float(got["lr"]), float(want["lr"]),
                                   rtol=1e-6)
    assert int(opt["step"]) == 3 and (("residual" in opt) == comp)
