"""The port's RecurrentGemma serving path against the JAX package's.

``reduced(recurrentgemma-9b)`` (d 64, 4 heads, 1 kv head, hd 16, window 8,
RG-LRU width 64, 2 x (rglru, rglru, local) + 2 rglru) with the reference's
f32 ``init_params``, carried over by ``params_from_jax``, runs on the CPU
through both packages on the same tokens (numpy, seeded): ``forward``
logits, prefill 12 + decode 14 (past the window, so the ring wraps), the
prefill/decode step functions and the continuous batcher.  Logits agree to
1e-4: the port scans the RG-LRU sequentially where the reference uses an
associative scan, and its einsums sum in another order.  Greedy tokens are
equal.  On the CPU the port's prefill runs the kernels' plain twins.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models import decode_step as ref_decode_step
from repro.models import forward as ref_forward
from repro.models import init_caches as ref_init_caches
from repro.models import init_params as ref_init_params
from repro.models import prefill as ref_prefill
from repro.models.model import param_count as ref_param_count
from repro.serve.batcher import ContinuousBatcher as RefBatcher
from repro.serve.batcher import Request as RefRequest
from repro.serve.step import make_decode_step as ref_make_decode_step
from repro.serve.step import make_prefill_step as ref_make_prefill_step
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.kernels import rglru_scan as rglru_kernels
from repro_torch.models import (blocks, decode_step, forward, init_caches,
                                init_params, param_count, params_from_jax,
                                prefill)
from repro_torch.serve import (ContinuousBatcher, Request, make_decode_step,
                               make_prefill_step)

ARCH = "recurrentgemma-9b"
TOL = 1e-4
T_PRE, T_DEC = 12, 14
CPU = "cpu"


@pytest.fixture(scope="module")
def setup():
    cfg = reduced(get_config(ARCH))
    ref_cfg = ref_reduced(ref_get_config(ARCH))
    ref_params = ref_init_params(ref_cfg, jax.random.key(0),
                                 dtype=jnp.float32)
    params = params_from_jax(jax.tree.map(np.asarray, ref_params), cfg, CPU)
    toks = np.random.default_rng(1).integers(
        2, cfg.vocab, size=(2, T_PRE + T_DEC)).astype(np.int32)
    return cfg, ref_cfg, ref_params, params, toks


@pytest.fixture(scope="module")
def ref_decode(setup):
    """The reference's decode step, compiled once for the module (its
    batcher compiles it the same way)."""
    ref_cfg = setup[1]
    return jax.jit(lambda p, t, pos, c: ref_decode_step(p, ref_cfg, t, pos, c))


def test_configs_and_param_count_match_reference():
    assert ARCHS == REF_ARCHS
    for shrink in (False, True):
        cfg, ref_cfg = get_config(ARCH), ref_get_config(ARCH)
        if shrink:
            cfg, ref_cfg = reduced(cfg), ref_reduced(ref_cfg)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
        assert param_count(cfg) == ref_param_count(ref_cfg)
    with pytest.raises(ValueError, match="unknown architecture"):
        get_config("xlstm-1t")


def test_forward_matches_reference(setup):
    cfg, ref_cfg, ref_params, params, toks = setup
    want, _ = ref_forward(ref_params, ref_cfg, jnp.asarray(toks),
                          mode="train", remat=False)
    got, caches = forward(params, cfg, torch.from_numpy(toks))
    assert caches is None and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


def test_prefill_and_decode_match_reference(setup, ref_decode):
    """Prefill 12, then 14 teacher-forced decode steps (the window is 8,
    so the local layers' rings wrap), logits at every step."""
    cfg, ref_cfg, ref_params, params, toks = setup
    n = T_PRE + T_DEC + 4
    ref_caches = ref_init_caches(ref_cfg, 2, n, dtype=jnp.float32)
    caches = init_caches(cfg, 2, n, dtype=torch.float32, device=CPU)
    want, ref_caches = ref_prefill(ref_params, ref_cfg,
                                   jnp.asarray(toks[:, :T_PRE]), ref_caches)
    got, caches = prefill(params, cfg, torch.from_numpy(toks[:, :T_PRE]),
                          caches)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    for i in range(T_DEC):
        step = toks[:, T_PRE + i: T_PRE + i + 1]
        want, ref_caches = ref_decode(
            ref_params, jnp.asarray(step),
            jnp.full((2,), T_PRE + i, jnp.int32), ref_caches)
        got, caches = decode_step(params, cfg, torch.from_numpy(step),
                                  torch.full((2,), T_PRE + i), caches)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TOL, atol=TOL,
                                   err_msg=f"decode step {i}")


def test_step_functions_match_reference(setup):
    """Greedy generation through make_prefill_step / make_decode_step:
    the same tokens from both packages."""
    cfg, ref_cfg, ref_params, params, toks = setup
    n = T_PRE + 10
    ref_caches = ref_init_caches(ref_cfg, 2, n, dtype=jnp.float32)
    caches = init_caches(cfg, 2, n, dtype=torch.float32, device=CPU)
    ref_tok, ref_caches = ref_make_prefill_step(ref_cfg)(
        ref_params, jnp.asarray(toks[:, :T_PRE]), ref_caches)
    tok, caches = make_prefill_step(cfg)(
        params, torch.from_numpy(toks[:, :T_PRE]), caches)
    ref_dec = jax.jit(ref_make_decode_step(ref_cfg))
    dec = make_decode_step(cfg)
    for i in range(6):
        assert tok.dtype == torch.int32
        np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok),
                                      err_msg=f"token {i}")
        pos = T_PRE + i
        ref_tok, ref_caches = ref_dec(ref_params, ref_tok[:, None],
                                      jnp.full((2,), pos, jnp.int32),
                                      ref_caches)
        tok, caches = dec(params, tok[:, None], torch.full((2,), pos),
                          caches)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))


def test_batcher_matches_reference(setup):
    """Four requests through two slots: admission, decode, eviction and
    re-admission into a used slot give the reference's tokens."""
    cfg, ref_cfg, ref_params, params, _ = setup
    rng = np.random.default_rng(7)
    prompts = [rng.integers(2, cfg.vocab, size=n).astype(np.int32)
               for n in (5, 11, 3, 14)]
    max_new = (6, 3, 5, 4)
    ref = RefBatcher(ref_cfg, ref_params, n_slots=2, cache_len=24)
    ours = ContinuousBatcher(cfg, params, n_slots=2, cache_len=24,
                             device=CPU)
    for i, (p, m) in enumerate(zip(prompts, max_new)):
        ref.submit(RefRequest(i, p, max_new=m))
        ours.submit(Request(i, p, max_new=m))
    assert ours.run_until_drained() == ref.run_until_drained()
    got = {r.rid: r.out for r in ours.completed}
    want = {r.rid: r.out for r in ref.completed}
    assert got == want
    assert all(len(got[i]) == m for i, m in enumerate(max_new))


def test_prefill_runs_the_kernel_entry_points(setup, monkeypatch):
    """Prefill attention is flash_attention and the RG-LRU scan is
    rglru_scan (through RGLRUScan, the autograd function the block calls),
    once per local / rglru layer; decode uses neither."""
    cfg, _, _, params, toks = setup
    calls = {"flash": 0, "scan": 0}

    def count(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(blocks, "flash_attention",
                        count("flash", blocks.flash_attention))
    monkeypatch.setattr(rglru_kernels, "rglru_scan",
                        count("scan", rglru_kernels.rglru_scan))
    caches = init_caches(cfg, 2, 16, dtype=torch.float32, device=CPU)
    _, caches = prefill(params, cfg, torch.from_numpy(toks[:, :T_PRE]),
                        caches, last_only=True)
    assert calls == {"flash": 2, "scan": 6}
    decode_step(params, cfg, torch.from_numpy(toks[:, T_PRE:T_PRE + 1]),
                torch.full((2,), T_PRE), caches)
    assert calls == {"flash": 2, "scan": 6}


def test_params_from_jax_rejects_a_mismatched_tree(setup):
    cfg, _, ref_params, _, _ = setup
    tree = jax.tree.map(np.asarray, ref_params)
    tree["stacks"]["s0"]["b2"]["attn"]["wq"] = \
        tree["stacks"]["s0"]["b2"]["attn"]["wq"][..., :-1]
    with pytest.raises(ValueError, match="wq"):
        params_from_jax(tree, cfg, CPU)
    del tree["stacks"]["s1"]
    with pytest.raises(ValueError, match="stacks"):
        params_from_jax(tree, cfg, CPU)


def test_entry_points_need_a_card_unless_given_the_cpu(setup, monkeypatch):
    cfg, _, ref_params, params, _ = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: init_params(cfg),
                 lambda: init_caches(cfg, 1, 8),
                 lambda: params_from_jax(jax.tree.map(np.asarray, ref_params),
                                         cfg),
                 lambda: ContinuousBatcher(cfg, params)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    p0 = init_params(cfg, seed=3, dtype=torch.float32, device=CPU)
    p1 = init_params(cfg, seed=3, dtype=torch.float32, device=CPU)
    assert torch.equal(p0["stacks"]["s0"][1]["b2"]["attn"]["wo"],
                       p1["stacks"]["s0"][1]["b2"]["attn"]["wo"])


@pytest.mark.parametrize("what", ["mlstm", "slstm", "xlstm-350m"])
def test_unported_block_types_raise(what):
    """Every block type is ported now, the xLSTM pair included (its
    parity is tests/test_torch_xlstm.py): its block types initialise and
    its config loads; a block type no package knows still raises."""
    if what == "xlstm-350m":
        assert get_config(what).stacks == (
            (("mlstm", "mlstm", "mlstm", "slstm"), 6),)
        return
    cfg = reduced(get_config(ARCH))
    xlstm = dataclasses.replace(cfg, stacks=(((what,), 1),))
    assert set(init_params(xlstm, device=CPU)["stacks"]["s0"][0]["b0"]) \
        == {"ln1", "mix"}
    with pytest.raises(ValueError, match="mamba"):
        init_params(dataclasses.replace(cfg, stacks=((("mamba",), 1),)),
                    device=CPU)
