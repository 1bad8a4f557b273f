"""The port's memory families against the JAX package: llama-3.2-vision-11b
(cross-attention to a stub of vision patches every fifth layer) and
whisper-medium (an encoder stack over a stub of audio frames, then
self+cross decoder layers), each reduced, on the CPU, to 1e-4 on logits
and exactly on tokens (``tests/_torch_archs.py`` states the setup).  The
reference's batcher takes no memory, so these two are served through the
step functions."""
import numpy as np
import pytest
import torch

import _torch_archs as P
from repro_torch.configs import get_config, reduced
from repro_torch.models import (blocks, decode_step, forward, init_caches,
                                prefill)
from repro_torch.models.blocks import Ctx
from repro_torch.models.model import _run_stacks

ARCHS = ["llama-3.2-vision-11b", "whisper-medium"]
# flash calls at prefill: llama 8 self + 2 cross layers; whisper 2 encoder
# layers + 2 decoder layers of self and cross
N_FLASH = {"llama-3.2-vision-11b": 10, "whisper-medium": 6}


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    return P.make_setup(request.param)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_param_counts_match_reference(arch):
    P.check_configs(arch)


def test_forward_matches_reference(setup):
    P.check_forward(setup)


def test_prefill_and_decode_match_reference(setup):
    P.check_prefill_decode(setup)


def test_step_functions_match_reference(setup):
    P.check_step_functions(setup)


def test_flash_once_an_encoder_and_cross_layer_at_prefill_none_at_decode(
        setup, monkeypatch):
    assert P.flash_calls(setup, monkeypatch) == (N_FLASH[setup.arch], 0)


def _first_cross_cache(cfg, caches):
    unit = cfg.stacks[0][0]
    if "self+cross" in unit:
        return caches["s0"][0][f"b{unit.index('self+cross')}"]["cross"]
    return caches["s0"][0][f"b{unit.index('cross')}"]


def test_cross_caches_hold_the_memory_projection(setup):
    """Prefill writes each cross layer's keys and values over the whole
    memory, (B, memory_len, Kv, hd); decode hands the same tensors on."""
    cfg = setup.cfg
    caches = init_caches(cfg, P.B, 16, dtype=torch.float32, device=P.CPU)
    _, caches = prefill(setup.params, cfg,
                        torch.from_numpy(setup.toks[:, :P.T_PRE]), caches,
                        memory=setup.memory())
    cross = _first_cross_cache(cfg, caches)
    assert set(cross) == {"k", "v"}
    assert cross["k"].shape == (P.B, cfg.memory_len, cfg.n_kv_heads, cfg.hd)
    step = torch.from_numpy(setup.toks[:, P.T_PRE:P.T_PRE + 1])
    _, after = decode_step(setup.params, cfg, step,
                           torch.full((P.B,), P.T_PRE), caches)
    kept = _first_cross_cache(cfg, after)
    assert kept["k"] is cross["k"] and kept["v"] is cross["v"]


def test_mixed_types_meet_in_the_wider_one():
    """A bf16 query over f32 keys and values (a bf16 decoder over f32
    memory): the kernel takes one type, so ``_attend_prefill`` computes in
    f32 and returns v's type, as the reference's f32 ``_attend_dense``
    does."""
    cfg = reduced(get_config("llama-3.2-vision-11b"))
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 5, 4, 16)).astype(
        np.float32)).to(torch.bfloat16)
    k, v = (torch.from_numpy(rng.standard_normal((2, 9, 2, 16)).astype(
        np.float32)) for _ in range(2))
    got = blocks._attend_prefill(q, k, v, cfg, causal=False, window=None)
    want = blocks._attend_dense(q, k, v, torch.ones((5, 9), dtype=torch.bool),
                                cfg)
    assert got.dtype == want.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=P.TOL, atol=P.TOL)


def test_enc_caches_stand_in_for_the_encoder(setup):
    """``enc_caches`` is an encoder output used as it is: the decoder over
    it equals the decoder given the raw memory (whisper: after the encoder
    stacks and their final norm)."""
    cfg, params = setup.cfg, setup.params
    toks = torch.from_numpy(setup.toks[:, :P.T_PRE])
    want, _ = forward(params, cfg, toks, memory=setup.memory())
    mem = setup.memory()
    if cfg.encoder_stacks:
        mpos = torch.arange(cfg.memory_len)[None].expand(P.B, -1)
        mem, _ = _run_stacks(params["enc_stacks"], cfg.encoder_stacks, mem,
                             cfg, Ctx("train", mpos), None)
        mem = blocks.rmsnorm(params["enc_final_norm"], mem, cfg.norm_eps)
    got, _ = forward(params, cfg, toks, enc_caches=mem)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
