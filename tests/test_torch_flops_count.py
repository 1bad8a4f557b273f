"""The port's flop count of a step (``repro_torch.launch.flops_count``)
against the reference's jaxpr count on the same reduced config and shapes,
without a mesh: ``count_flops`` over ``make_step_and_specs(cfg, shape,
None)`` traced on meta equals ``repro.launch.flops_count.count_flops`` of
``jax.make_jaxpr`` of the reference's step, for train, prefill and decode.

Tolerance 0, with two stated differences, both in xlstm's mLSTM:

* One op.  The chunk's exit state takes ``einsum("bhj,bhjv,bhjk->bhvk",
  w, v, k)``.  The reference's einsum makes ``w v`` a dot_general with no
  contracted dim, which its counter counts as ``2 B H L hd`` FLOPs per
  chunk; torch's einsum multiplies the pair elementwise, which
  FlopCounterMode does not count.  The prefill is held to the reference's
  count less exactly that op (0.15 % of the reduced prefill below).
* Training.  The reference's mLSTM is a ``lax.scan`` over chunks, and the
  scan's transpose computes the carry's cotangent through every chunk:
  through the last chunk's exit state, which training never reads, and
  into the first chunk's initial state, a constant.  The port's autograd
  prunes both.  With the ``w v`` op four times (forward, the checkpoint's
  recomputation, and its two transposes) the port's count is lower by
  0.50 % of the step at two chunks (the shape below), and less as chunks
  are added.  It is held to within 1 %, and at least the four ``w v``
  ops below the reference's.
"""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.launch import specs as ref_specs
from repro.launch.flops_count import count_flops as ref_count_flops
from repro.serve.step import make_decode_step as ref_decode_step
from repro.serve.step import make_prefill_step as ref_prefill_step
from repro.train.optimizer import AdamWConfig as RefAdamWConfig
from repro.train.optimizer import init_opt_state as ref_init_opt_state
from repro.train.step import make_train_step as ref_train_step
from repro_torch.configs import ShapeSpec, get_config, reduced
from repro_torch.launch.flops_count import count_flops
from repro_torch.launch.specs import make_step_and_specs
from repro_torch.models import init_caches, init_params

ARCHS = ("internlm2-1.8b", "recurrentgemma-9b", "qwen3-moe-235b-a22b",
         "xlstm-350m", "whisper-medium")
KINDS = ("train", "prefill", "decode")
B, T = 4, 32
XLSTM_TRAIN_T = 300          # two mLSTM chunks of 256, the second padded
SDS = jax.ShapeDtypeStruct


def _seq(arch: str, kind: str) -> int:
    return XLSTM_TRAIN_T if (arch, kind) == ("xlstm-350m", "train") else T


def ref_flops(arch: str, kind: str, b: int, t: int) -> float:
    cfg = ref_reduced(ref_get_config(arch))
    p = ref_specs.param_shapes(cfg)
    mem = (SDS((b, cfg.memory_len, cfg.d_model), jnp.bfloat16)
           if cfg.memory_len else None)
    if kind == "train":
        batch = {"tokens": SDS((b, t), jnp.int32)}
        if mem is not None:
            batch["memory"] = mem
        opt = jax.eval_shape(lambda: ref_init_opt_state(p))
        step, args = ref_train_step(cfg, RefAdamWConfig()), (p, opt, batch)
    elif kind == "prefill":
        step = ref_prefill_step(cfg)
        args = (p, SDS((b, t), jnp.int32), ref_specs.cache_shapes(cfg, b, t))
        args += (mem,) if mem is not None else ()
    else:
        step = ref_decode_step(cfg)
        args = (p, SDS((b, 1), jnp.int32), SDS((b,), jnp.int32),
                ref_specs.cache_shapes(cfg, b, t))
    return ref_count_flops(jax.make_jaxpr(step)(*args))


def wv_flops(arch: str, b: int, t: int) -> int:
    """The reference's count of the mLSTM's ``w v`` dot_general over one
    pass of the step: ``2 B H L hd`` per chunk of every mLSTM layer."""
    cfg = reduced(get_config(arch))
    layers = sum(pattern.count("mlstm") * n for pattern, n in cfg.stacks)
    hd = int(cfg.d_model * cfg.mlstm_expand) // cfg.n_heads
    chunk = cfg.mlstm_chunk
    return 2 * b * cfg.n_heads * chunk * hd * -(-t // chunk) * layers


def port_flops(arch: str, kind: str, b: int, t: int) -> int:
    step, args, in_pl, _, _ = make_step_and_specs(
        reduced(get_config(arch)), ShapeSpec("test", t, b, kind), None)
    assert in_pl is None
    return count_flops(step, *args)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_global_flops_equal_reference_jaxpr(arch, kind):
    t = _seq(arch, kind)
    want = ref_flops(arch, kind, B, t)
    got = port_flops(arch, kind, B, t)
    assert want > 0
    if (arch, kind) == ("xlstm-350m", "train"):
        assert 4 * wv_flops(arch, B, t) < want - got <= 0.01 * want, \
            (got, want)
    elif (arch, kind) == ("xlstm-350m", "prefill"):
        assert got == want - wv_flops(arch, B, t), (got, want)
    else:
        assert got == want


@pytest.mark.parametrize("arch", ("recurrentgemma-9b", "internlm2-1.8b"))
def test_meta_count_equals_cpu_count(arch):
    """The same prefill and decode counted on meta and run on CPU tensors
    (the flash and scan ops counted by their formulas on both)."""
    cfg = reduced(get_config(arch))
    params = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    tokens = torch.randint(2, cfg.vocab, (B, T), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(0))
    for kind in ("prefill", "decode"):
        step, args, _, _, _ = make_step_and_specs(
            cfg, ShapeSpec("test", T, B, kind), None)
        caches = init_caches(cfg, B, T, dtype=torch.float32, device="cpu")
        real = (params, tokens, caches) if kind == "prefill" else \
            (params, tokens[:, :1], torch.zeros(B, dtype=torch.int32),
             caches)
        with torch.no_grad():
            assert count_flops(step, *real) == count_flops(step, *args)
