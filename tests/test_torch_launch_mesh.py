"""The port's launch layer against the reference's, with no ranks, and its
trainer across ranks on the CPU.

* The sharding rules: every leaf's ``param_spec`` (policies ``2d``,
  ``zero3``, ``tp``) and ``opt_shardings`` spec of all ten architectures at
  full size, ``cache_spec`` of their caches and ``batch_spec``, on abstract
  (16, 16), (2, 16, 16), (4, 2) and (1, 1) meshes, equal the reference's
  (shapes from the meta device and ``jax.eval_shape``).  The port keeps a
  layer per dict where the reference stacks them, so a stacked leaf's spec
  is the reference's without its leading ``None``.  JAX writes a one-axis
  tuple entry as the axis name; so do the comparisons.  Then
  ``tests/test_launch.py``'s rule cases on the port's layout.
* The CLI under ``torchrun --nproc-per-node 4 ... --device cpu`` (a 2 x 2
  mesh, ``--model-parallel 2``): killed at step 12 and resumed on the same
  ranks; and the elastic restore, a one-rank checkpoint resumed on the
  2 x 2 mesh and a 2 x 2 checkpoint resumed on one rank.  Steps 10 to 19
  equal the uninterrupted one-rank run's within 1e-5
  (``tests/test_substrate.py``'s bound).
"""
import functools
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_config as ref_get_config
from repro.launch import sharding as ref_sh
from repro.models import init_caches as ref_init_caches
from repro.models import init_params as ref_init_params
from repro.train.optimizer import init_opt_state as ref_init_opt_state

from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import sharding as sh
from repro_torch.launch.sharding import P, MeshShape
from repro_torch.models import init_caches, init_params
from repro_torch.train import init_opt_state
from repro_torch.tree import tree_leaves, tree_paths

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "1x1": ((1, 1), ("data", "model"))}
POLICIES = ("2d", "zero3", "tp")
CACHE_CASES = ((128, 32768), (1, 524288))      # (batch, cache length)
_STACKED = re.compile(r"s\d+$")


def _abstract_mesh(sizes, names):
    try:
        return AbstractMesh(sizes, names)              # jax >= 0.4.38
    except TypeError:
        return AbstractMesh(tuple(zip(names, sizes)))  # jax <= 0.4.37


def _norm(spec) -> tuple:
    """A spec's entries with a one-axis tuple written as the axis name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _ref_specs(tree, specs) -> dict:
    """{key names: spec without the stacked leading None} of a reference
    tree and its tree of NamedShardings (or specs)."""
    out = {}
    for (path, _), s in zip(
            jax.tree_util.tree_leaves_with_path(tree),
            jax.tree.leaves(specs, is_leaf=lambda x: hasattr(x, "spec"))):
        names = tuple(ref_sh._path_names(path))
        spec = _norm(getattr(s, "spec", s))
        if any(_STACKED.match(n) for n in names):
            spec = spec[1:]
        out.setdefault(names, set()).add(spec)
    return out


def _port_specs(tree, specs) -> dict:
    out = {}
    for path, s in zip(tree_paths(tree), tree_leaves(specs)):
        out.setdefault(tuple(sh._path_names(path)), set()).add(_norm(s))
    return out


@functools.lru_cache(maxsize=None)
def _shapes(arch: str):
    ref_cfg = ref_get_config(arch)
    ref_p = jax.eval_shape(lambda: ref_init_params(
        ref_cfg, jax.random.key(0), dtype=jnp.float32))
    ref_o = jax.eval_shape(lambda: ref_init_opt_state(ref_p))
    cfg = get_config(arch)
    p = init_params(cfg, dtype=torch.float32, device="meta")
    caches = {}
    for b, length in CACHE_CASES:
        caches[b] = (jax.eval_shape(lambda b=b, n=length: ref_init_caches(
            ref_cfg, b, n)), init_caches(cfg, b, length, device="meta"))
    return ref_p, ref_o, p, init_opt_state(p), caches


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_rules_match_reference(arch, mesh):
    sizes, names = MESHES[mesh]
    ref_mesh, port_mesh = _abstract_mesh(sizes, names), MeshShape(names,
                                                                   sizes)
    ref_p, ref_o, p, o, caches = _shapes(arch)
    for policy in POLICIES:
        want = _ref_specs(ref_p, ref_sh.param_shardings(ref_mesh, ref_p,
                                                         policy))
        got = _port_specs(p, sh.param_shardings(port_mesh, p, policy))
        assert got == want, (policy, "params")
        want = _ref_specs(ref_o, ref_sh.opt_shardings(ref_mesh, ref_o,
                                                       policy))
        got = _port_specs(o, sh.opt_shardings(port_mesh, o, policy))
        assert got == want, (policy, "opt")
    for b, (ref_c, c) in caches.items():
        want = _ref_specs(ref_c, jax.tree.map(
            lambda leaf, b=b: ref_sh.cache_spec(ref_mesh, leaf, b), ref_c))
        got = _port_specs(c, sh.cache_shardings(port_mesh, c, b))
        assert got == want, ("caches", b)
    for b in (1, 2, 8, 32, 256):
        for ndim in (2, 3):
            for policy in ("2d", "zero3"):
                assert _norm(sh.batch_spec(port_mesh, b, ndim, policy)) == \
                    _norm(ref_sh.batch_spec(ref_mesh, b, ndim, policy))


# ------------------------------------------------ tests/test_launch.py's cases
MESH = MeshShape(("data", "model"), (16, 16))
MESH3 = MeshShape(("pod", "data", "model"), (2, 16, 16))


class Leaf:
    def __init__(self, shape):
        self.shape = shape


def test_param_spec_rules():
    # embed (V, D): vocab->model, d->data
    assert sh.param_spec("/embed", Leaf((262144, 3840)), MESH) == \
        P("model", "data")
    # a layer's attn wq (one dict a layer: no repeat dim)
    path = "/stacks/s0/3/b0/attn/wq"
    assert sh.param_spec(path, Leaf((3840, 4096)), MESH) == \
        P("data", "model")
    # moe experts: EP over model
    path = ("stacks", "s0", 0, "b0", "moe", "wi")
    assert sh.param_spec(path, Leaf((128, 4096, 1536)), MESH) == \
        P("model", "data", None)
    # non-divisible dims fall back to None: 36 heads % 16 != 0
    spec = sh.param_spec("/stacks/s0/0/b0/attn/wq", Leaf((2304, 36 * 64)),
                         MESH)
    assert spec == P("data", "model")


def test_param_spec_zero3():
    spec = sh.param_spec("/stacks/s0/0/b0/mlp/wi", Leaf((2048, 8192)), MESH,
                         policy="zero3")
    assert spec == P(("data", "model"), None)


def test_batch_spec():
    assert sh.batch_spec(MESH3, 256, 2) == P(("pod", "data"), None)
    assert sh.batch_spec(MESH, 256, 2) == P(("data",), None)
    assert sh.batch_spec(MESH, 1, 2) == P(None, None)      # long_500k: b=1
    assert sh.batch_spec(MESH, 256, 2, policy="zero3") == \
        P(("data", "model"), None)


def test_cache_spec():
    # (B, L, Kv, hd): batch over dp, kv-heads over model when divisible
    s = sh.cache_spec(MESH, Leaf((128, 32768, 16, 128)), 128)
    assert s == P(("data",), None, "model", None)
    # kv=1 (MQA): falls back to sequence sharding over model
    s = sh.cache_spec(MESH, Leaf((128, 32768, 1, 256)), 128)
    assert s == P(("data",), "model", None, None)
    # b=1 long context: no batch sharding, seq over model
    s = sh.cache_spec(MESH, Leaf((1, 524288, 8, 256)), 1)
    assert s[0] is None and "model" in (s[1], s[2])


def test_to_placements_maps_specs_onto_mesh_dims():
    class Mesh:
        mesh_dim_names = ("pod", "data", "model")

    assert sh.to_placements(P(("pod", "data"), None, "model"), Mesh()) == \
        [Shard(0), Shard(0), Shard(2)]
    assert sh.to_placements(P(None, None), Mesh()) == [Replicate()] * 3
    for bad in (P(("data", "pod"), None), P("data", "data"),
                P("expert", None)):
        with pytest.raises(ValueError, match="does not map"):
            sh.to_placements(bad, Mesh())


def test_rules_mesh_reads_a_device_mesh():
    class DeviceMesh:
        mesh_dim_names = ("data", "model")
        shape = (4, 2)

    got = sh.rules_mesh(DeviceMesh())
    assert got == MeshShape(("data", "model"), (4, 2))
    assert got.shape == {"data": 4, "model": 2}


def test_meshes_over_a_one_rank_job():
    """A host mesh spans every rank; the production meshes need exactly
    their 256 or 512 ranks (the dry run's shapes)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import (dp_axes, init_ranks,
                                         make_host_mesh,
                                         make_production_mesh)
    assert init_ranks(torch.device("cpu")) == (0, 1)
    try:
        mesh = make_host_mesh()
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (1, 1) and dp_axes(mesh) == ("data",)
        with pytest.raises(ValueError, match="spans every rank"):
            make_host_mesh(n_devices=4)
        for multi_pod, n in ((False, 256), (True, 512)):
            with pytest.raises(ValueError, match=f"needs {n} ranks"):
                make_production_mesh(multi_pod=multi_pod)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------- the CLI
SRC = str(Path(__file__).resolve().parents[1] / "src")
COMMON = ["--smoke", "--steps", "20", "--batch", "4", "--seq", "64",
          "--ckpt-every", "10", "--log-every", "1", "--device", "cpu"]
ONE = [sys.executable, "-m", "repro_torch.launch.train"]
FOUR = [sys.executable, "-m", "torch.distributed.run", "--standalone",
        "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
        "--model-parallel", "2"]
TIMEOUT = 180


def _start(cmd, d, *extra):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    return subprocess.Popen(cmd + COMMON + ["--ckpt-dir", str(d), *extra],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)


def _finish(procs: dict) -> dict:
    out = {}
    try:
        for k, p in procs.items():
            out[k] = (p.wait(timeout=TIMEOUT), *p.communicate())
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def _losses(d):
    return {json.loads(line)["step"]: json.loads(line)["loss"]
            for line in (d / "metrics.jsonl").read_text().splitlines()}


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    t = tmp_path_factory.mktemp("cli")
    first = _finish({
        "full": _start(ONE, t / "full"),
        "die one": _start(ONE, t / "one", "--die-at-step", "12"),
        "die four": _start(FOUR, t / "four", "--die-at-step", "12")})
    dirs = {k: sorted(p.name for p in (t / k).glob("step_*"))
            for k in ("one", "four")}
    shutil.copytree(t / "four", t / "four_to_one")
    second = _finish({
        "resume four": _start(FOUR, t / "four", "--resume"),
        "one to four": _start(FOUR, t / "one", "--resume"),
        "four to one": _start(ONE, t / "four_to_one", "--resume")})
    return {"t": t, "dirs_at_failure": dirs, **first, **second}


def _check_resumed(cli, run, d):
    rc, out, err = cli[run]
    assert rc == 0, err[-3000:]
    assert "resumed from step 10" in out
    assert out.splitlines()[-1].startswith("final loss ")
    a, b = _losses(cli["t"] / "full"), _losses(cli["t"] / d)
    assert sorted(a) == list(range(20)) == sorted(b)
    for s in range(10, 20):               # post-resume steps match
        assert abs(a[s] - b[s]) < 1e-5, (s, a[s], b[s])
    assert json.loads((cli["t"] / d / "heartbeat.json").read_text())[
        "step"] == 19
    assert sorted(p.name for p in (cli["t"] / d).glob("step_*")) == \
        ["step_00000010", "step_00000020"]


def test_cli_die_and_resume_under_torchrun(cli):
    assert cli["full"][0] == 0, cli["full"][2][-3000:]
    rc, out, err = cli["die four"]
    assert rc != 0 and "exitcode  : 42" in err        # every rank exits 42
    assert out.count("SIMULATED FAILURE at step 12") == 1   # rank 0 prints
    assert cli["dirs_at_failure"]["four"] == ["step_00000010"]
    _check_resumed(cli, "resume four", "four")


def test_elastic_restore_one_rank_to_2x2_and_back(cli):
    rc, out, err = cli["die one"]
    assert rc == 42 and "SIMULATED FAILURE at step 12" in out, err[-3000:]
    assert cli["dirs_at_failure"]["one"] == ["step_00000010"]
    _check_resumed(cli, "one to four", "one")
    _check_resumed(cli, "four to one", "four_to_one")
