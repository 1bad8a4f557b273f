"""Parity checks of the port's LM against the JAX package, one architecture
at a time, shared by ``tests/test_torch_archs_dense.py``,
``tests/test_torch_archs_memory.py``, ``tests/test_torch_moe.py`` and
``tests/test_torch_xlstm.py``, and the training checks' inputs
(``train_inputs``, ``tests/test_torch_train*.py``).

For an architecture, ``reduced()`` of its config and the reference's f32
``init_params``, carried over by ``params_from_jax``, run on the CPU through
both packages on the same seeded numpy tokens (and, for the vlm and audio
families, the same seeded memory stub of ``memory_len`` frames): ``forward``
logits, prefill 12 + decode 14 (past the window of 8, so the local rings
wrap), the step functions and the continuous batcher.  Logits agree to
``TOL``: the port's einsums and its plain flash twin sum in another order
than XLA does.  Greedy tokens are equal.  On the CPU the port's prefill
attention runs the kernel's plain twin.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models import decode_step as ref_decode_step
from repro.models import forward as ref_forward
from repro.models import init_caches as ref_init_caches
from repro.models import init_params as ref_init_params
from repro.models import prefill as ref_prefill
from repro.models.model import active_param_count as ref_active_param_count
from repro.models.model import param_count as ref_param_count
from repro.serve.batcher import ContinuousBatcher as RefBatcher
from repro.serve.batcher import Request as RefRequest
from repro.serve.step import make_decode_step as ref_make_decode_step
from repro.serve.step import make_prefill_step as ref_make_prefill_step
from repro_torch.configs import get_config, reduced
from repro_torch.models import (active_param_count, blocks, decode_step,
                                forward, init_caches, param_count,
                                params_from_jax, prefill)
from repro_torch.serve import (ContinuousBatcher, Request, make_decode_step,
                               make_prefill_step)

TOL = 1e-4
B, T_PRE, T_DEC = 2, 12, 14
CPU = "cpu"


@dataclasses.dataclass
class Setup:
    arch: str
    cfg: object
    ref_cfg: object
    ref_params: dict
    params: dict
    toks: np.ndarray
    mem: np.ndarray | None
    ref_decode: object       # the reference's decode step, jitted once

    def memory(self):
        return None if self.mem is None else torch.from_numpy(self.mem)

    def ref_memory(self):
        return None if self.mem is None else jnp.asarray(self.mem)


def make_setup(arch: str) -> Setup:
    cfg = reduced(get_config(arch))
    ref_cfg = ref_reduced(ref_get_config(arch))
    ref_params = ref_init_params(ref_cfg, jax.random.key(0),
                                 dtype=jnp.float32)
    params = params_from_jax(jax.tree.map(np.asarray, ref_params), cfg, CPU)
    toks = np.random.default_rng(1).integers(
        2, cfg.vocab, size=(B, T_PRE + T_DEC)).astype(np.int32)
    mem = None
    if cfg.memory_len:
        mem = (np.random.default_rng(9).standard_normal(
            (B, cfg.memory_len, cfg.d_model)) * 0.02).astype(np.float32)
    ref_decode = jax.jit(lambda p, t, pos, c, m: ref_decode_step(
        p, ref_cfg, t, pos, c, memory=m))
    return Setup(arch, cfg, ref_cfg, ref_params, params, toks, mem,
                 ref_decode)


def check_configs(arch: str) -> None:
    """The config at full size and reduced equals the reference's field by
    field, and so do the parameter counts (the port's from meta tensors)."""
    for shrink in (False, True):
        cfg, ref_cfg = get_config(arch), ref_get_config(arch)
        if shrink:
            cfg, ref_cfg = reduced(cfg), ref_reduced(ref_cfg)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
        assert param_count(cfg) == ref_param_count(ref_cfg)
        assert active_param_count(cfg) == ref_active_param_count(ref_cfg)


def check_forward(s: Setup) -> None:
    want, _ = ref_forward(s.ref_params, s.ref_cfg, jnp.asarray(s.toks),
                          memory=s.ref_memory(), mode="train", remat=False)
    got, caches = forward(s.params, s.cfg, torch.from_numpy(s.toks),
                          memory=s.memory())
    assert caches is None and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


def check_prefill_decode(s: Setup) -> None:
    """Prefill 12, then 14 teacher-forced decode steps, the memory given at
    both (with encoder stacks, decode runs the encoder again, as in the
    reference's tests/test_multistep_decode.py), logits at every step."""
    n = T_PRE + T_DEC + 4
    ref_caches = ref_init_caches(s.ref_cfg, B, n, dtype=jnp.float32)
    caches = init_caches(s.cfg, B, n, dtype=torch.float32, device=CPU)
    want, ref_caches = ref_prefill(s.ref_params, s.ref_cfg,
                                   jnp.asarray(s.toks[:, :T_PRE]),
                                   ref_caches, memory=s.ref_memory())
    got, caches = prefill(s.params, s.cfg, torch.from_numpy(s.toks[:, :T_PRE]),
                          caches, memory=s.memory())
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    for i in range(T_DEC):
        step = s.toks[:, T_PRE + i: T_PRE + i + 1]
        want, ref_caches = s.ref_decode(
            s.ref_params, jnp.asarray(step),
            jnp.full((B,), T_PRE + i, jnp.int32), ref_caches,
            s.ref_memory())
        got, caches = decode_step(s.params, s.cfg, torch.from_numpy(step),
                                  torch.full((B,), T_PRE + i), caches,
                                  memory=s.memory())
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TOL, atol=TOL,
                                   err_msg=f"decode step {i}")


def check_step_functions(s: Setup) -> None:
    """Greedy generation through make_prefill_step (given the memory) and
    make_decode_step (which takes none: cross-attention reads the caches
    prefill wrote): the same tokens from both packages."""
    n = T_PRE + 10
    ref_caches = ref_init_caches(s.ref_cfg, B, n, dtype=jnp.float32)
    caches = init_caches(s.cfg, B, n, dtype=torch.float32, device=CPU)
    ref_tok, ref_caches = ref_make_prefill_step(s.ref_cfg)(
        s.ref_params, jnp.asarray(s.toks[:, :T_PRE]), ref_caches,
        memory=s.ref_memory())
    tok, caches = make_prefill_step(s.cfg)(
        s.params, torch.from_numpy(s.toks[:, :T_PRE]), caches,
        memory=s.memory())
    ref_dec = jax.jit(ref_make_decode_step(s.ref_cfg))
    dec = make_decode_step(s.cfg)
    for i in range(6):
        assert tok.dtype == torch.int32
        np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok),
                                      err_msg=f"token {i}")
        pos = T_PRE + i
        ref_tok, ref_caches = ref_dec(s.ref_params, ref_tok[:, None],
                                      jnp.full((B,), pos, jnp.int32),
                                      ref_caches)
        tok, caches = dec(s.params, tok[:, None], torch.full((B,), pos),
                          caches)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ref_tok))


def check_batcher(s: Setup) -> None:
    """Four requests through two slots: admission, decode, eviction and
    re-admission into a used slot give the reference's tokens."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(2, s.cfg.vocab, size=n).astype(np.int32)
               for n in (5, 11, 3, 14)]
    max_new = (6, 3, 5, 4)
    ref = RefBatcher(s.ref_cfg, s.ref_params, n_slots=2, cache_len=24)
    ours = ContinuousBatcher(s.cfg, s.params, n_slots=2, cache_len=24,
                             device=CPU)
    for i, (p, m) in enumerate(zip(prompts, max_new)):
        ref.submit(RefRequest(i, p, max_new=m))
        ours.submit(Request(i, p, max_new=m))
    assert ours.run_until_drained() == ref.run_until_drained()
    got = {r.rid: r.out for r in ours.completed}
    want = {r.rid: r.out for r in ref.completed}
    assert got == want
    assert all(len(got[i]) == m for i, m in enumerate(max_new))


def flash_calls(s: Setup, monkeypatch) -> tuple[int, int]:
    """How many times prefill (given the memory) and then one decode step
    (given none) call ``flash_attention``."""
    calls = [0]
    inner = blocks.flash_attention

    def counted(*args, **kw):
        calls[0] += 1
        return inner(*args, **kw)

    monkeypatch.setattr(blocks, "flash_attention", counted)
    caches = init_caches(s.cfg, B, 16, dtype=torch.float32, device=CPU)
    _, caches = prefill(s.params, s.cfg, torch.from_numpy(s.toks[:, :T_PRE]),
                        caches, memory=s.memory(), last_only=True)
    at_prefill = calls[0]
    decode_step(s.params, s.cfg,
                torch.from_numpy(s.toks[:, T_PRE:T_PRE + 1]),
                torch.full((B,), T_PRE), caches)
    return at_prefill, calls[0] - at_prefill


TRAIN_B, TRAIN_T1 = 2, 17     # tokens a row: 16 positions with a next token


def train_inputs(arch: str):
    """For the training checks: the reduced configs of both packages, the
    reference's f32 parameters from key 0, seeded numpy tokens (TRAIN_B,
    TRAIN_T1) and, for the vlm and audio families, the memory stub."""
    cfg = reduced(get_config(arch))
    ref_cfg = ref_reduced(ref_get_config(arch))
    ref_params = ref_init_params(ref_cfg, jax.random.key(0),
                                 dtype=jnp.float32)
    toks = np.random.default_rng(1).integers(
        2, cfg.vocab, size=(TRAIN_B, TRAIN_T1)).astype(np.int32)
    mem = None
    if cfg.memory_len:
        mem = (np.random.default_rng(9).standard_normal(
            (TRAIN_B, cfg.memory_len, cfg.d_model)) * 0.02).astype(
                np.float32)
    return cfg, ref_cfg, ref_params, toks, mem
