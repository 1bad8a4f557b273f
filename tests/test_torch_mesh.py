"""The port's mesh path on the CPU: four ``gloo`` ranks on a 2 x 2 ("data",
"model") mesh and one rank on a 1 x 1 mesh, in one subprocess
(``tests/_torch_mesh_job.py``) run once for the module:

* ``to_placements``: ``distribute`` then ``full_tensor`` gives the tensor
  back for each kind of spec, and each rank's shard is JAX's block;
* expert-parallel MoE (``_apply_moe_shardmap``, taken by ``apply_moe``)
  for qwen3 and for arctic with its dense residual, at ``MoEConfig(8, 2,
  64, capacity_factor=8.0)``: values equal the port's ``_apply_moe_xla``
  and the reference's within ``rtol 2e-4, atol 2e-5`` (the reference's own
  EP test's tolerance), every gradient (input included) within 1e-4 of its
  leaf's max of the single-process one (the reference's test only checks
  that they are finite);
* three ``make_train_step`` steps under the 2 x 2 mesh (reduced internlm2
  microbatched, reduced recurrentgemma compressed, reduced qwen3-moe, whose
  MoE takes expert parallelism) against the same steps without a mesh:
  losses within 1e-5; every parameter and moment within 1e-5, or for the
  microbatched and compressed steps within the spread the no-mesh step
  itself shows between two orderings of the same sums, measured in the
  same job (2.8e-5 and 6.5e-5 on this machine: Adam scales gradients near
  its eps by their own size, and an int8 rounding tie moves a quantum);
  on the 1 x 1 mesh equal bit for bit;
* prefill (12 tokens into caches of 16) and three greedy decode steps,
  bound under the mesh by ``launch.specs.make_step_and_specs`` with the
  parameters and caches placed (reduced internlm2, recurrentgemma and
  qwen3-moe, whose prefill MoE takes expert parallelism and whose decode
  does not), against the same steps without a mesh: every step's logits
  within 1e-4, every token equal; on the 1 x 1 mesh all equal bit for bit.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models import blocks as ref_blocks
from repro.models.config import MoEConfig as RefMoEConfig

ROOT = Path(__file__).resolve().parents[1]
JOB = ROOT / "tests" / "_torch_mesh_job.py"
EP_ARCHS = {"qwen3-moe-235b-a22b": False, "arctic-480b": True}
TRAIN_ARCHS = ("internlm2-1.8b", "recurrentgemma-9b", "qwen3-moe-235b-a22b")
SERVE_ARCHS = ("internlm2-1.8b", "recurrentgemma-9b", "qwen3-moe-235b-a22b")
JOB_TIMEOUT = 180


def _ref_ep(arch: str):
    cfg = dataclasses.replace(
        ref_reduced(ref_get_config(arch)),
        moe=RefMoEConfig(8, 2, 64, dense_residual=EP_ARCHS[arch],
                         capacity_factor=8.0))
    p = ref_blocks.init_moe(cfg, jax.random.key(0), dtype=jnp.float32)
    x = np.random.default_rng(1).standard_normal((4, 16, 64)).astype(
        np.float32)
    return cfg, p, x


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh")
    for arch in EP_ARCHS:
        _, p, x = _ref_ep(arch)
        flat = {"/".join(k.key for k in path): np.asarray(leaf)
                for path, leaf in jax.tree_util.tree_leaves_with_path(p)}
        np.savez(d / f"ep_{arch}.npz", x=x, **flat)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, str(JOB), str(d)], env=env,
                          capture_output=True, text=True,
                          timeout=JOB_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = {}
    for name in ("mesh_2x2.json", "mesh_1x1.json"):
        res[name] = json.loads((d / name).read_text())
    res["dir"] = d
    return res


def test_to_placements_round_trip(job):
    cases = job["mesh_2x2.json"]["placements"]
    assert len(cases) == 8
    for c in cases:
        assert c["round_trip"] and c["shard"], c


@pytest.mark.parametrize("arch", list(EP_ARCHS))
def test_expert_parallel_moe_values(job, arch):
    res = job["mesh_2x2.json"][f"ep {arch}"]
    assert res["shardmap_calls"] == 1
    got = np.load(job["dir"] / f"ep_{arch}_out.npy")
    cfg, p, x = _ref_ep(arch)
    want = np.asarray(ref_blocks._apply_moe_xla(p, jnp.asarray(x), cfg))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    assert res["max_abs_vs_port_xla"] <= 2e-5 + 2e-4 * np.abs(want).max()


@pytest.mark.parametrize("arch", list(EP_ARCHS))
def test_expert_parallel_moe_gradients(job, arch):
    errs = job["mesh_2x2.json"][f"ep {arch}"]["grad_rel_err"]
    want = {"/router", "/wi", "/wg", "/wo", "/x"}
    if EP_ARCHS[arch]:
        want |= {"/dense/wi", "/dense/wg", "/dense/wo"}
    assert set(errs) == want
    for name, err in errs.items():
        assert err <= 1e-4, (name, err)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_steps_on_2x2_match_no_mesh(job, arch):
    res = job["mesh_2x2.json"][f"train {arch}"]
    assert res["params_are_dtensors"] and res["step"] == 3
    assert res["max_abs_loss"] <= 1e-5, res
    # parameters and moments: 1e-5, or where microbatching or int8 rounding
    # make the no-mesh step itself differ by more between two orderings of
    # the same sums, that spread (Adam divides gradients near its eps by
    # their own size; a rounding tie moves a whole quantum)
    assert max(res["max_abs"].values()) <= max(1e-5,
                                               res["no_mesh_spread"]), res
    assert (res["no_mesh_spread"] > 0) == (arch != TRAIN_ARCHS[2])
    # qwen3's MoE takes expert parallelism: 2 layers x 3 steps, forward
    # and the remat's recomputation
    assert res["shardmap_calls"] == (12 if "moe" in arch else 0)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_steps_on_1x1_equal_no_mesh(job, arch):
    res = job["mesh_1x1.json"][f"train {arch}"]
    assert res["params_are_dtensors"] and res["step"] == 3
    assert res["equal"], res
    assert res["shardmap_calls"] == 0      # model axis 1: single-device MoE


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_prefill_decode_on_2x2_match_no_mesh(job, arch):
    res = job["mesh_2x2.json"][f"serve {arch}"]
    assert res["steps"] == 4                # prefill + 3 decode steps
    assert res["tokens_equal"], res
    assert res["max_abs_logits"] <= 1e-4, res
    # qwen3's prefill MoE takes expert parallelism (2 layers); decode at
    # T = 1 stays on the single-device dispatch, as the reference rules
    assert res["shardmap_calls"] == (2 if "moe" in arch else 0)


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_prefill_decode_on_1x1_equal_no_mesh(job, arch):
    res = job["mesh_1x1.json"][f"serve {arch}"]
    assert res["tokens_equal"] and res["logits_equal"], res
    assert res["shardmap_calls"] == 0
