"""The port's single-device MoE against the JAX package: qwen3-moe-235b-a22b
(128 experts top-8, qk-norm) and arctic-480b (128 experts top-2 beside a
dense residual MLP), each reduced (4 experts, top 2, capacity factor 4, so
no token is dropped), on the CPU, to 1e-4 on logits and exactly on tokens
(``tests/_torch_archs.py`` states the setup); and the dispatch itself:
against an explicit per-token expert mix, and against the reference's
``_apply_moe_xla`` where capacity drops tokens.  The combine adds at most
two experts' outputs to a zero row per token, which rounds the same in
either order, so MoE needs no looser tolerance than the dense families."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import _torch_archs as P
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models import blocks as ref_blocks
from repro.models import init_params as ref_init_params
from repro.models.config import MoEConfig as RefMoEConfig
from repro_torch.configs import get_config, reduced
from repro_torch.models import MoEConfig, blocks, init_params, \
    params_from_jax

ARCHS = ["qwen3-moe-235b-a22b", "arctic-480b"]


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


def test_batcher_matches_reference(setup):
    P.check_batcher(setup)


def test_prefill_runs_flash_once_a_layer(setup, monkeypatch):
    assert P.flash_calls(setup, monkeypatch) == (2, 0)


def _moe(capacity_factor):
    """qwen3's reduced MoE layer at this capacity, from the reference's
    init (key 3), and an input (key 4), in f32 in both packages."""
    moe = (4, 2, 64)
    ref_cfg = dataclasses.replace(
        ref_reduced(ref_get_config("qwen3-moe-235b-a22b")),
        moe=RefMoEConfig(*moe, capacity_factor=capacity_factor))
    cfg = dataclasses.replace(
        reduced(get_config("qwen3-moe-235b-a22b")),
        moe=MoEConfig(*moe, capacity_factor=capacity_factor))
    ref_p = ref_blocks.init_moe(ref_cfg, jax.random.key(3),
                                dtype=jnp.float32)
    x = jax.random.normal(jax.random.key(4), (2, 8, cfg.d_model), jnp.float32)
    p = {k: torch.from_numpy(np.array(v)) for k, v in ref_p.items()}
    return cfg, ref_cfg, p, ref_p, torch.from_numpy(np.array(x)), x


def test_moe_routing_matches_dense_reference():
    """Sort-based dispatch == explicit per-token expert mix at high
    capacity (the port of tests/test_archs_smoke.py's test)."""
    cfg, _, p, _, x, _ = _moe(8.0)
    got = blocks.apply_moe(p, x, cfg)

    xt = x.reshape(-1, cfg.d_model)
    probs = torch.softmax(xt @ p["router"], dim=-1)
    w, ids = torch.topk(probs, 2, dim=-1)
    w = w / w.sum(-1, keepdim=True)
    dense = torch.zeros_like(xt)
    for e in range(4):
        out = (F.silu(xt @ p["wg"][e]) * (xt @ p["wi"][e])) @ p["wo"][e]
        dense += (w * (ids == e)).sum(-1, keepdim=True) * out
    torch.testing.assert_close(got.reshape(-1, cfg.d_model), dense,
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("capacity_factor", [0.25, 0.5, 1.25, 8.0])
def test_moe_dispatch_matches_reference_where_capacity_drops(
        capacity_factor):
    """The slot arithmetic (stable sort by expert, place in bucket, drop
    past capacity) against the reference's: at factors 0.25 and 0.5 most
    assignments are dropped, at 1.25 (the default) some."""
    cfg, ref_cfg, p, ref_p, x, ref_x = _moe(capacity_factor)
    got = blocks.apply_moe(p, x, cfg)
    want = ref_blocks.apply_moe(ref_p, ref_x, ref_cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


def test_router_stays_f32_under_bf16_weights():
    """Both packages draw the router in f32 whatever the weights' type, and
    ``params_from_jax`` carries a bf16 tree over with its f32 router."""
    cfg = reduced(get_config("arctic-480b"))
    ref_cfg = ref_reduced(ref_get_config("arctic-480b"))
    ours = init_params(cfg, dtype=torch.bfloat16, device=P.CPU)
    moe = ours["stacks"]["s0"][0]["b0"]["moe"]
    assert moe["router"].dtype == torch.float32
    assert moe["wi"].dtype == moe["dense"]["wi"].dtype == torch.bfloat16
    ref = ref_init_params(ref_cfg, jax.random.key(0), dtype=jnp.bfloat16)
    got = params_from_jax(jax.tree.map(np.asarray, ref), cfg, P.CPU)
    router = got["stacks"]["s0"][1]["b0"]["moe"]["router"]
    assert router.dtype == torch.float32
    np.testing.assert_array_equal(
        router.numpy(),
        np.asarray(ref["stacks"]["s0"]["b0"]["moe"]["router"][1]))
    assert got["unembed"].dtype == torch.bfloat16
