"""The port's ``loss_fn`` and its gradients against the JAX package's
``jax.value_and_grad(loss_fn)`` on the CPU, for each of the ten
architectures, reduced, with the reference's f32 parameters carried over by
``params_from_jax`` (the setup of ``tests/test_torch_train.py``)."""
import _torch_archs as P
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.models import loss_fn as ref_loss_fn
from repro_torch.configs import ARCHS
from repro_torch.models import loss_fn, params_from_jax
from repro_torch.tree import tree_leaves


def test_archs_are_the_reference_ten():
    assert ARCHS == REF_ARCHS


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_loss_and_grads_match_reference(arch):
    """loss_fn to 1e-5 relative, every gradient leaf to 1e-4 of its
    largest magnitude: the port sums in another order than XLA (and runs
    its own loops for scans), so the last bits differ."""
    cfg, ref_cfg, ref_params, toks, mem = P.train_inputs(arch)
    ref_mem = None if mem is None else jnp.asarray(mem)
    want, want_g = jax.jit(jax.value_and_grad(
        lambda p: ref_loss_fn(p, ref_cfg, jnp.asarray(toks), ref_mem)))(
            ref_params)
    want_g = params_from_jax(jax.tree.map(np.asarray, want_g), cfg, "cpu")
    params = params_from_jax(jax.tree.map(np.asarray, ref_params), cfg,
                             "cpu")
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    got = loss_fn(params, cfg, torch.from_numpy(toks),
                  None if mem is None else torch.from_numpy(mem))
    grads = torch.autograd.grad(got, leaves)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for g, w in zip(grads, tree_leaves(want_g)):
        w = w.numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * max(np.abs(w).max(), 1e-30))


