"""The port's dense attention families against the JAX package: gemma3-12b
(5:1 local:global, qk-norm, post-norms), internlm2-1.8b (untied
embeddings), gemma2-27b (attention and final soft-caps, post-norms) and
minicpm-2b (embedding, residual and logit scales), each reduced, on the
CPU, to 1e-4 on logits and exactly on tokens (``tests/_torch_archs.py``
states the setup)."""
import pytest

import _torch_archs as P

ARCHS = ["gemma3-12b", "internlm2-1.8b", "gemma2-27b", "minicpm-2b"]
# prefill attention layers of each reduced config: one flash call each
N_ATTN = {"gemma3-12b": 12, "internlm2-1.8b": 2, "gemma2-27b": 4,
          "minicpm-2b": 2}


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
    assert P.flash_calls(setup, monkeypatch) == (N_ATTN[setup.arch], 0)
