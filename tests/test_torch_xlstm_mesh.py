"""The xLSTM blocks split over ``model`` on the CPU: four ``gloo`` ranks as a
2 x 2 ("data", "model") mesh and as a (data 1, model 4) mesh, then one rank
on a 1 x 1 mesh, in one subprocess (``tests/_torch_xlstm_mesh_job.py``),
run once for the module and apart from ``tests/test_torch_mesh.py``'s job,
so that a crash of one takes none of the other's cases with it:

* each block run of the job's ``BLOCK_RUNS`` (reduced xlstm-350m at chunk
  8, so that a prompt of 21 crosses two chunk edges and a pad): the mLSTM
  on 2 x 2 (4 heads, two a rank), the sLSTM on 2 x 2 (its ``up`` / ``down``
  whole, as xlstm-350m's, and split where ``slstm_proj`` 2.0 makes their
  width even), and the mLSTM on (1, 4) with 2 heads (half a head a rank,
  as xlstm-350m's 4 heads over 16): prefill and three decode steps over
  states placed by ``cache_spec``, and the train-mode forward with every
  gradient, each within ``rtol 2e-4, atol 2e-5`` (for a gradient, 2e-5 of
  its leaf's largest magnitude) of the reference's ``apply_mlstm`` /
  ``apply_slstm`` on the same numpy inputs and of the port in one
  process; every gradient back in its weight's placement;
* the weights a block computes with keep their ``model`` shard wherever
  ``param_spec`` places one, and each state keeps ``cache_spec``'s
  ``model`` entry, each rank's shard the slice of the one-process state
  that its placement names; plain states under tensor parallelism raise;
* reduced xlstm-350m's three train steps and its prefill and three decode
  steps on 2 x 2 against the same steps without a mesh, within the bounds
  of ``tests/test_torch_mesh.py``'s archs;
* on 1 x 1 all of it equal bit for bit to the runs without a mesh;
* on (1, 4), attention's case C at arctic's split (reduced arctic at 6 q
  heads over 2 kv heads: 1.5 q heads and half a kv head a rank, the
  halo exchange of the heads a rank's columns touch): prefill and three
  decode steps over a ring split by length, and a windowed ring of 8 that
  wraps over ten, and the train-mode forward with every gradient, held
  as ``tests/test_torch_mesh.py`` holds the 2 x 2 attention runs, the
  caches placed as ``cache_spec`` places them.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models import blocks as ref_blocks
from repro_torch.configs import get_config, reduced
from repro_torch.launch import sharding as sh
from repro_torch.models import blocks

import _torch_mesh_job as J
import _torch_xlstm_mesh_job as XJ
from test_torch_mesh import _close_to_both as _close_to_mesh
from test_torch_mesh import _ref_serve_block, _ref_train_block

ROOT = Path(__file__).resolve().parents[1]
JOB = ROOT / "tests" / "_torch_xlstm_mesh_job.py"
JOB_TIMEOUT = 300
RUNS = list(XJ.BLOCK_RUNS)
RTOL, ATOL = 2e-4, 2e-5          # the RG-LRU's, tests/test_torch_mesh.py


def _close_to_both(got, want: dict) -> None:
    """Every array of ``want`` (the reference's) against the mesh's and the
    one-process port's in ``got``, and those two against each other.  A
    gradient's atol is ATOL times its leaf's largest magnitude (at least
    1): the gradients of ``sum(y ** 2)`` reach 10^3 here, where two f32
    orders of the same sums (XLA's and torch's, in one process) already
    differ by 10^-6 of that in elements near zero."""
    for k, v in want.items():
        atol = ATOL * max(1.0, float(np.abs(v).max())) \
            if k.startswith("g/") else ATOL
        for who in ("mesh", "port"):
            np.testing.assert_allclose(got[f"{who}/{k}"], v, rtol=RTOL,
                                       atol=atol, err_msg=f"{who} {k}")
        np.testing.assert_allclose(got[f"mesh/{k}"], got[f"port/{k}"],
                                   rtol=RTOL, atol=atol, err_msg=k)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    d = tmp_path_factory.mktemp("xlstm_mesh")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, str(JOB), str(d)], env=env,
                          capture_output=True, text=True,
                          timeout=JOB_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = {m: json.loads((d / f"xlstm_{m}.json").read_text())
           for m in ("2x2", "1x4", "1x1")}
    res["dir"] = d
    return res


def _mesh_of(run: str) -> str:
    return XJ.BLOCK_RUNS[run][2]


def _tp(run: str) -> int:
    return XJ.MESHES[_mesh_of(run)][1]


def _got(job, mesh: str, kind: str, run: str):
    return np.load(job["dir"] / f"xblock_{mesh}_{kind} {run}.npz")


def _ref(run: str):
    """The reference's config, numpy inputs, parameters and block."""
    cfg = XJ.block_config(run, ref_get_config, ref_reduced)
    arrays = XJ.block_inputs(run, cfg)
    p = {k[2:]: jnp.asarray(v) for k, v in arrays.items()
         if k.startswith("p/")}
    mlstm = XJ.BLOCK_RUNS[run][0] == "mlstm"
    return cfg, arrays, p, (ref_blocks.apply_mlstm if mlstm
                            else ref_blocks.apply_slstm)


def _ref_serve(run: str) -> dict:
    cfg, arrays, p, apply = _ref(run)
    cache = (ref_blocks.init_mlstm_cache if XJ.BLOCK_RUNS[run][0] == "mlstm"
             else ref_blocks.init_slstm_cache)(cfg, XJ.B)

    def step(mode):
        return jax.jit(lambda p, x, c: apply(
            p, x, cfg, ref_blocks.Ctx(mode, None, None, c)))

    prefill, decode = step("prefill"), step("decode")
    want = {}
    for i in range(XJ.STEPS + 1):
        x = arrays["x"] if i == 0 else arrays["xd"][i - 1]
        y, cache = (prefill if i == 0 else decode)(p, jnp.asarray(x), cache)
        want[f"y{i}"] = np.asarray(y)
    want.update({f"cache/{k}": np.asarray(v) for k, v in cache.items()})
    return want


def _ref_train(run: str) -> dict:
    cfg, arrays, p, apply = _ref(run)

    def f(p, x):
        return apply(p, x, cfg, ref_blocks.Ctx("train"))[0]

    x = jnp.asarray(arrays["x"])
    gp, gx = jax.jit(jax.grad(lambda p, x: jnp.sum(f(p, x) ** 2),
                              (0, 1)))(p, x)
    want = {"y": np.asarray(jax.jit(f)(p, x)), "g/x": np.asarray(gx)}
    want.update({f"g/{k}": np.asarray(v) for k, v in gp.items()})
    return want


@pytest.mark.parametrize("run", RUNS)
def test_xlstm_block_prefill_decode(job, run):
    got = _got(job, _mesh_of(run), "serve", run)
    want = _ref_serve(run)
    assert len([k for k in want if k.startswith("y")]) == XJ.STEPS + 1
    _close_to_both(got, want)


@pytest.mark.parametrize("run", RUNS)
def test_xlstm_block_train_gradients(job, run):
    got = _got(job, _mesh_of(run), "train", run)
    want = _ref_train(run)
    # every gradient comes back in its weight's placement; a weight that
    # is gathered with its gradient summed over model and needed no gather
    # over data (size 1 at (1, 4)) comes back partial over model, which
    # ``placed_like`` sums (the RG-LRU's a_log likewise)
    names = [k[2:] for k in want if k.startswith("g/") and k != "g/x"]
    unplaced = {k for k in names if not bool(got[f"mesh/placed/{k}"][0])}
    assert unplaced == ({"wi", "wf"} if run == "mlstm h2" else set())
    for k in unplaced:
        assert str(got[f"mesh/gpl/{k}"][0]) == "(Shard(dim=0), Partial(sum))"
    _close_to_both(got, want)


def _split_dim(spec) -> int:
    return next((i for i, e in enumerate(spec) if e == "model"), -1)


@pytest.mark.parametrize("run", RUNS)
def test_xlstm_weights_keep_model_shards(job, run):
    """The local shape of each weight the block computes with on the mesh:
    its whole shape with the dim that ``param_spec`` places over ``model``
    split ``tp`` ways, gathered over ``data``."""
    shapes = job[_mesh_of(run)]["blocks"][run]["shapes"]
    cfg = XJ.block_config(run, get_config, reduced)
    arrays = XJ.block_inputs(run, cfg)
    tp = _tp(run)
    mesh = sh.MeshShape(("data", "model"), XJ.MESHES[_mesh_of(run)])
    p = {k[2:]: torch.from_numpy(v) for k, v in arrays.items()
         if k.startswith("p/")}
    specs = sh.param_shardings(mesh, p)
    want, split = {}, set()
    for k, t in p.items():
        shape, d = list(t.shape), _split_dim(specs[k])
        if d >= 0:
            shape[d] //= tp
            split.add(k)
        want[k] = shape
    assert shapes == want
    block, _, _ = XJ.BLOCK_RUNS[run]
    if block == "mlstm":
        keep = {"wu", "wg", "wq", "wk", "wv", "wo"}
        if cfg.n_heads % tp == 0:
            keep.add("wi")
    else:
        keep = {"wi", "wo"} | ({"up", "down"} if run == "slstm ffn"
                               else set())
    assert split == keep


@pytest.mark.parametrize("run", RUNS)
def test_xlstm_states_keep_cache_spec_entries(job, run):
    """Each state's dim over ``model`` is ``cache_spec``'s, and each rank's
    local shard is the slice of the one-process state its placement
    names: the mLSTM's C every head's value rows, n every head's k entries,
    m its heads where model divides them; the sLSTM's channels."""
    states = job[_mesh_of(run)]["blocks"][run]["states"]
    cfg = XJ.block_config(run, get_config, reduced)
    mlstm = XJ.BLOCK_RUNS[run][0] == "mlstm"
    cache = (blocks.init_mlstm_cache if mlstm
             else blocks.init_slstm_cache)(cfg, XJ.B, "cpu")
    mesh = sh.MeshShape(("data", "model"), XJ.MESHES[_mesh_of(run)])
    assert set(states) == set(cache)
    for k, leaf in cache.items():
        assert states[k]["split"] == _split_dim(sh.cache_spec(mesh, leaf,
                                                              XJ.B)), k
        assert not states[k]["nonfinite_differ"], k
        assert states[k]["max_abs"] <= ATOL + RTOL * states[k]["scale"], k
    heads_split = cfg.n_heads % _tp(run) == 0
    want = {"C": 2, "n": 2, "m": 1 if heads_split else -1} if mlstm else \
        {"c": 1, "n": 1, "m": 1}
    assert {k: v["split"] for k, v in states.items()} == want


def test_xlstm_refuses_plain_states(job):
    # the states' local shards cannot say that they are shards: under
    # tensor parallelism each block takes its states placed and raises on
    # the local tensors
    for run in RUNS:
        said = job[_mesh_of(run)]["blocks"][run]["plain"]
        assert "caches placed (DTensors)" in said, (run, said)


@pytest.mark.parametrize("run", RUNS)
def test_xlstm_blocks_on_1x1_equal_no_mesh(job, run):
    for kind in ("serve", "train"):
        got = _got(job, "1x1", kind, run)
        mesh = sorted(k for k in got.files if k.startswith("mesh/")
                      and not k.startswith(("mesh/placed/", "mesh/gpl/")))
        assert mesh
        for k in mesh:
            np.testing.assert_array_equal(got[k], got[f"port/{k[5:]}"],
                                          err_msg=f"{kind} {k}")
    assert job["1x1"]["blocks"][run]["plain"] == ""


def test_xlstm_train_steps_on_2x2_match_no_mesh(job):
    res = job["2x2"]["train"]
    assert res["params_are_dtensors"] and res["step"] == 3
    assert res["no_mesh_spread"] == 0.0         # no microbatches, no int8
    assert res["max_abs_loss"] <= 1e-5, res
    assert max(res["max_abs"].values()) <= 1e-5, res


def test_xlstm_train_steps_on_1x1_equal_no_mesh(job):
    res = job["1x1"]["train"]
    assert res["params_are_dtensors"] and res["step"] == 3
    assert res["equal"], res


def test_xlstm_prefill_decode_on_2x2_match_no_mesh(job):
    res = job["2x2"]["serve"]
    assert res["steps"] == 4                # prefill + 3 decode steps
    assert res["tokens_equal"], res
    assert res["max_abs_logits"] <= 1e-4, res
    assert res["logit_cols"] == [256] * 4, res["logit_cols"]


def test_xlstm_prefill_decode_on_1x1_equal_no_mesh(job):
    res = job["1x1"]["serve"]
    assert res["tokens_equal"] and res["logits_equal"], res
    assert res["logit_cols"] == [512] * 4, res["logit_cols"]


# ------------------------------------------ attention's case C on (1, 4)
@pytest.mark.parametrize("run", list(J.SERVE_BLOCKS_1X4))
def test_tp_attention_case_c_on_1x4_prefill_decode(job, run):
    assert sorted(job["1x4"]["attention"]) == sorted(
        [f"serve {r}" for r in J.SERVE_BLOCKS_1X4]
        + [f"train {r}" for r in J.TRAIN_BLOCKS_1X4])
    got = np.load(job["dir"] / f"block_1x4_serve {run}.npz")
    # k / pos / v split by the ring's length: 2 kv heads do not divide 4
    assert list(got["mesh/split"]) == [1, 1, 1]
    want = _ref_serve_block(run)
    assert len([k for k in want if k.startswith("y")]) == \
        J.serve_spec(run)[5] + 1
    _close_to_mesh(got, want)


@pytest.mark.parametrize("run", J.TRAIN_BLOCKS_1X4)
def test_tp_attention_case_c_on_1x4_train_gradients(job, run):
    got = np.load(job["dir"] / f"block_1x4_train {run}.npz")
    want = _ref_train_block(run)
    # wq, wk, wv and wo keep their model shard, and their gradients come
    # back in it (data has one rank: nothing else to reduce)
    names = [k[2:] for k in want if k.startswith("g/") and k != "g/x"]
    assert sorted(names) == ["wk", "wo", "wq", "wv"]
    for k in names:
        assert bool(got[f"mesh/placed/{k}"][0]), k
    _close_to_mesh(got, want)
