"""The port's xLSTM family (mLSTM, sLSTM, xlstm-350m) on the CPU, mirroring
``tests/test_xlstm_forms.py`` and ``tests/test_multistep_decode.py``: the
chunkwise-parallel mLSTM equals the exact sequential recurrence at every
chunk split, state carries across calls, gradients flow through the
chunked form; and xlstm-350m, reduced, with the reference's f32 parameters
(``params_from_jax``), gives the reference's logits at forward, prefill
and decode to 1e-4 (``tests/_torch_archs.py``), and a teacher-forced
decode equals its own forward."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_archs as P
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models import blocks as ref_blocks
from repro_torch.configs import get_config, reduced
from repro_torch.models import blocks as BL
from repro_torch.models import (decode_step, forward, init_caches,
                                init_params, prefill)
from repro_torch.models.blocks import Ctx

ARCH = "xlstm-350m"
TOL = dict(rtol=1e-4, atol=1e-5)       # the reference's, test_xlstm_forms


def _setup(t, seed=0):
    """Reduced xlstm-350m at chunk 8; the mLSTM's parameters and input
    drawn with numpy (N(0, 0.02) weights, N(0, 1) input)."""
    cfg = dataclasses.replace(reduced(get_config(ARCH)), mlstm_chunk=8)
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)

    def dense(shape, dtype):
        return torch.empty(shape, dtype=dtype).normal_(0.0, 0.02,
                                                       generator=gen)

    p = BL.init_mlstm(cfg, dense, torch.float32)
    x = torch.from_numpy(rng.standard_normal((2, t, cfg.d_model)).astype(
        np.float32))
    return cfg, p, x


@pytest.mark.parametrize("t", [1, 7, 8, 24, 33])
def test_chunked_matches_sequential(t):
    cfg, p, x = _setup(t)
    out_c, cache_c = BL.apply_mlstm(p, x, cfg, Ctx("prefill"))
    # sequential path: force decode-mode math over the whole sequence
    out_s, cache_s = BL.apply_mlstm(p, x, cfg, Ctx("decode"))
    np.testing.assert_allclose(out_c.numpy(), out_s.numpy(), **TOL)
    for k in ("C", "n", "m"):
        np.testing.assert_allclose(cache_c[k].numpy(), cache_s[k].numpy(),
                                   **TOL)


def test_state_carry_across_calls():
    """prefill(x1) then prefill-with-state(x2) == prefill(concat(x1,x2))."""
    cfg, p, x = _setup(32, seed=3)
    full, cache_full = BL.apply_mlstm(p, x, cfg, Ctx("prefill"))
    a, cache_a = BL.apply_mlstm(p, x[:, :20], cfg, Ctx("prefill"))
    b, cache_b = BL.apply_mlstm(p, x[:, 20:], cfg,
                                Ctx("prefill", cache=cache_a))
    np.testing.assert_allclose(torch.cat([a, b], 1).numpy(), full.numpy(),
                               **TOL)
    for k in ("C", "n", "m"):
        np.testing.assert_allclose(cache_b[k].numpy(),
                                   cache_full[k].numpy(), **TOL)


def test_grad_through_chunked_form():
    """Gradients through the chunked form (each chunk checkpointed) are
    finite and equal the reference's ``jax.grad`` on the same parameters
    and input."""
    cfg, p, x = _setup(24, seed=5)
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    out, _ = BL.apply_mlstm(leaves, x, cfg, Ctx("train"))
    torch.sum(out ** 2).backward()
    got = {k: v.grad for k, v in leaves.items()}
    assert all(bool(torch.isfinite(g).all()) for g in got.values())

    ref_cfg = dataclasses.replace(ref_reduced(ref_get_config(ARCH)),
                                  mlstm_chunk=8)
    rp = {k: jnp.asarray(v.numpy()) for k, v in p.items()}

    def f(rp):
        o, _ = ref_blocks.apply_mlstm(rp, jnp.asarray(x.numpy()), ref_cfg,
                                      ref_blocks.Ctx("train"))
        return jnp.sum(o ** 2)

    want = jax.grad(f)(rp)
    for k, g in got.items():
        w = np.asarray(want[k])
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


def test_slstm_matches_reference():
    """The sLSTM block alone, prefill then one decode step with its state,
    against the reference's on the same parameters and input."""
    cfg = reduced(get_config(ARCH))
    ref_cfg = ref_reduced(ref_get_config(ARCH))
    rng = np.random.default_rng(11)
    rp = ref_blocks.init_slstm(ref_cfg, jax.random.key(2), dtype=jnp.float32)
    p = {k: torch.from_numpy(np.array(v)) for k, v in rp.items()}
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    want, ref_cache = ref_blocks.apply_slstm(rp, jnp.asarray(x[:, :8]),
                                             ref_cfg,
                                             ref_blocks.Ctx("prefill"))
    got, cache = BL.apply_slstm(p, torch.from_numpy(x[:, :8]), cfg,
                                Ctx("prefill"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want, _ = ref_blocks.apply_slstm(rp, jnp.asarray(x[:, 8:]), ref_cfg,
                                     ref_blocks.Ctx("decode",
                                                    cache=ref_cache))
    got, _ = BL.apply_slstm(p, torch.from_numpy(x[:, 8:]), cfg,
                            Ctx("decode", cache=cache))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def setup():
    return P.make_setup(ARCH)


def test_configs_and_param_counts_match_reference():
    P.check_configs(ARCH)


def test_forward_matches_reference(setup):
    P.check_forward(setup)


def test_prefill_and_decode_match_reference(setup):
    P.check_prefill_decode(setup)


def test_step_functions_match_reference(setup):
    P.check_step_functions(setup)


def test_batcher_matches_reference(setup):
    P.check_batcher(setup)


def test_teacher_forced_decode_matches_forward():
    """tests/test_multistep_decode.py on the port alone: prefill 12, then 14
    decode steps equal the cache-free forward at every position (within
    that test's 3e-2), with the port's own random parameters."""
    cfg = reduced(get_config(ARCH))
    params = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        2, cfg.vocab, size=(2, 26)).astype(np.int32))
    ref, _ = forward(params, cfg, toks)
    caches = init_caches(cfg, 2, 30, dtype=torch.float32, device="cpu")
    _, caches = prefill(params, cfg, toks[:, :12], caches)
    for i in range(14):
        logits, caches = decode_step(params, cfg, toks[:, 12 + i: 13 + i],
                                     torch.full((2,), 12 + i), caches)
        np.testing.assert_allclose(logits[:, 0].numpy(),
                                   ref[:, 12 + i].numpy(), rtol=3e-2,
                                   atol=3e-2, err_msg=f"decode step {i}")
