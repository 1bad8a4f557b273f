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
  its eps by their own size, and an int8 rounding tie moves a quantum; the
  other ordering groups the rows as the data ranks do and sums each
  attention and MLP block over the model ranks' parts); on the 1 x 1 mesh
  equal bit for bit; under ``zero3`` with a row a rank, MoE's values and
  gradients against ``_apply_moe_xla`` (8 experts split over both axes:
  expert parallelism; 6 over ``data`` alone: the dispatch); under
  ``zero3`` (reduced
  recurrentgemma and qwen3-moe,
  plain steps) at a batch of 2, where ``model`` splits the products, and of
  4, where it carries rows and expert parallelism gathers the model ranks'
  tokens: losses, parameters and moments within 1e-5;
* prefill (12 tokens into caches of 16) and three greedy decode steps,
  bound under the mesh by ``launch.specs.make_step_and_specs`` with the
  parameters and caches placed (reduced internlm2, recurrentgemma and
  qwen3-moe, whose prefill MoE takes expert parallelism and whose decode
  does not), against the same steps without a mesh: every step's logits
  within 1e-4, every token equal; on the 1 x 1 mesh all equal bit for bit;
  the same under ``zero3`` at a batch of 2 and of 4, and on 1 x 1;
* tensor parallelism over ``model`` block by block
  (``_torch_mesh_job.py``'s ``BLOCK_CFGS``): attention in its three head
  splits (A 4 / 2 heads with qk-norm, B 4 / 1, C 3 heads computed whole)
  and cross-attention (A, and B over a memory split by length), prefill
  then decode steps over caches placed by ``cache_spec`` (B's ring split by
  length, also windowed, soft-capped, wrapped and with a rank that sees no
  key; and a ring that does not divide), the train-mode forward with every
  gradient, and the MLP: each within ``rtol 2e-4, atol 2e-5`` of the
  reference's block on the same numpy inputs and of the port's in one
  process, every gradient back in its parameter's placement; and one
  reduced internlm2 layer's collectives: two all-reduces of its rows'
  activations (attention and MLP) and the data gathers of its weights, no
  gather over ``model``; none at all on 1 x 1;
* the vocabulary split over ``model``: a reference model's parameters
  (reduced recurrentgemma, tied, and internlm2, untied, vocab 512),
  converted by ``params_from_jax`` and placed on 2 x 2, give the
  reference's train-mode logits, ``loss_fn`` and every gradient within
  1e-4 (of the leaf's max for gradients), with no rank holding the whole
  ``embed`` / ``unembed`` or logits; at a vocab of 513, which 2 does not
  divide, the vocabulary stays whole with the same numbers; the served
  logits are each rank's columns (the model's contract) and whole on 1 x
  1; ``tensor_parallel.argmax`` breaks ties across ranks as
  ``torch.argmax`` does;
* the RG-LRU block over ``model``: prefill, decode (states placed by
  ``cache_spec``, their channels over ``model``) and the train-mode
  gradients against the reference's ``apply_rglru`` within ``rtol 2e-4,
  atol 2e-5``; plain states under ``model`` 2 raise; one reduced
  recurrentgemma RG-LRU layer's collectives: the conv output's gather over
  ``model``, the block's and the MLP's sums, the data gathers;
* one reduced xlstm-350m layer's collectives (its three mLSTM blocks and
  its sLSTM, ``tests/test_torch_xlstm_mesh.py`` holds the blocks
  themselves): the mLSTM's gathers of ``u`` and sums over ``model``, the
  sLSTM's reduce-scatter and gather, the data gathers; none on 1 x 1.
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
from repro.models import model as ref_model
from repro.models.config import MoEConfig as RefMoEConfig
from repro_torch.configs import get_config, reduced
from repro_torch.models import params_from_jax
from repro_torch.tree import tree_leaves, tree_paths

import _torch_mesh_job as J

ROOT = Path(__file__).resolve().parents[1]
JOB = ROOT / "tests" / "_torch_mesh_job.py"
EP_ARCHS = {"qwen3-moe-235b-a22b": False, "arctic-480b": True}
TRAIN_ARCHS = ("internlm2-1.8b", "recurrentgemma-9b", "qwen3-moe-235b-a22b")
SERVE_ARCHS = ("internlm2-1.8b", "recurrentgemma-9b", "qwen3-moe-235b-a22b")
JOB_TIMEOUT = 300


def _ref_ep(arch: str):
    cfg = dataclasses.replace(
        ref_reduced(ref_get_config(arch)),
        moe=RefMoEConfig(8, 2, 64, dense_residual=EP_ARCHS[arch],
                         capacity_factor=8.0))
    p = ref_blocks.init_moe(cfg, jax.random.key(0), dtype=jnp.float32)
    x = np.random.default_rng(1).standard_normal((4, 16, 64)).astype(
        np.float32)
    return cfg, p, x


def _flat(tree) -> dict:
    return {"/".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _ref_vocab(case: str):
    """The reference's reduced config of a VOCAB_CASES case, its f32
    parameters from key 0 and seeded numpy tokens."""
    arch, vocab = J.VOCAB_CASES[case]
    cfg = ref_reduced(ref_get_config(arch), vocab=vocab)
    p = ref_model.init_params(cfg, jax.random.key(0), dtype=jnp.float32)
    toks = np.random.default_rng(11).integers(
        2, vocab, size=(J.VOCAB_B, J.VOCAB_T1)).astype(np.int32)
    return cfg, p, toks


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh")
    for arch in EP_ARCHS:
        _, p, x = _ref_ep(arch)
        np.savez(d / f"ep_{arch}.npz", x=x, **_flat(p))
    for case in J.VOCAB_CASES:
        _, p, toks = _ref_vocab(case)
        np.savez(d / f"vocab_{case}.npz", tokens=toks,
                 **{f"p/{k}": v for k, v in _flat(p).items()})
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
    # the model's contract: under a vocabulary split the steps' logits are
    # this rank's columns (512 over 2), never gathered
    assert res["logit_cols"] == [256] * 4, res["logit_cols"]


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_prefill_decode_on_1x1_equal_no_mesh(job, arch):
    res = job["mesh_1x1.json"][f"serve {arch}"]
    assert res["tokens_equal"] and res["logits_equal"], res
    assert res["shardmap_calls"] == 0
    assert res["logit_cols"] == [512] * 4, res["logit_cols"]


# ---------------------------------------------------------------- zero3
@pytest.mark.parametrize("experts", J.ZERO3_EP_EXPERTS)
def test_zero3_expert_parallel_moe_with_rows_over_model(job, experts):
    """Each of the 4 ranks holds its own row.  With 8 experts split over
    both axes, expert parallelism gathers the model ranks' tokens, buckets
    them for the rank's experts and sums the outputs back into each rank's
    rows (a sum over ``model`` of the rank's own tokens would add different
    rows together); 6 experts, placed over ``data`` alone, take the
    dispatch."""
    res = job["mesh_2x2.json"][f"zero3 ep {experts}"]
    assert res["rows"] == 4
    assert res["shardmap_calls"] == (1 if experts == 8 else 0)
    assert res["experts_spec"] == ("P(('data', 'model'), None, None)"
                                   if experts == 8 else
                                   "P('data', None, None)")
    assert res["max_abs"] <= 2e-5 + 2e-4 * res["max_y"], res
    assert set(res["grad_rel_err"]) == {"/router", "/wi", "/wg", "/wo", "/x"}
    for name, err in res["grad_rel_err"].items():
        assert err <= 1e-4, (name, err)


@pytest.mark.parametrize("b", J.ZERO3_B)
@pytest.mark.parametrize("arch", J.ZERO3_TRAIN)
def test_zero3_train_steps_on_2x2_match_no_mesh(job, arch, b):
    """Parameters, moments and rows placed by ``zero3``: at a batch of 2
    ``model`` splits the products on views of the gathered weights, at 4
    it carries rows and expert parallelism gathers the model ranks'
    tokens; either way the no-mesh step's numbers."""
    res = job["mesh_2x2.json"][f"zero3 train {arch} b{b}"]
    assert res["params_are_dtensors"] and res["step"] == 3
    assert res["max_abs_loss"] <= 1e-5, res
    assert max(res["max_abs"].values()) <= 1e-5, res
    assert res["shardmap_calls"] == (12 if "moe" in arch else 0)


@pytest.mark.parametrize("b", J.ZERO3_B)
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_zero3_prefill_decode_on_2x2_match_no_mesh(job, arch, b):
    """The steps ``make_step_and_specs`` binds under ``zero3``, caches placed
    by ``cache_spec``: at a batch of 2 the vocabulary splits over ``model``
    (each rank's 256 columns), at 4 each rank computes its own row with the
    whole vocabulary."""
    res = job["mesh_2x2.json"][f"zero3 serve {arch} b{b}"]
    assert res["steps"] == 4
    assert res["tokens_equal"], res
    assert res["max_abs_logits"] <= 1e-4, res
    assert res["shardmap_calls"] == (2 if "moe" in arch else 0)
    assert res["logit_cols"] == [256 if b == 2 else 512] * 4, res


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_zero3_prefill_decode_on_1x1_equal_no_mesh(job, arch):
    res = job["mesh_1x1.json"][f"zero3 serve {arch}"]
    assert res["tokens_equal"] and res["logits_equal"], res
    assert res["shardmap_calls"] == 0
    assert res["logit_cols"] == [512] * 4, res["logit_cols"]


# ------------------------------------------------------------ the vocabulary
@pytest.mark.parametrize("case", list(J.VOCAB_CASES))
def test_vocab_parallel_matches_reference(job, case):
    res = job["mesh_2x2.json"][f"vocab {case}"]
    arch, vocab = J.VOCAB_CASES[case]
    ref_cfg, p, toks = _ref_vocab(case)
    d = ref_cfg.d_model
    # no rank holds the whole vocabulary where 2 divides it
    cols = vocab // 2 if vocab % 2 == 0 else vocab
    want_shapes = {"embed": [cols, d]}
    if not ref_cfg.tie_embeddings:
        want_shapes["unembed"] = [d, cols]
    assert res["local_shapes"] == want_shapes
    assert res["logit_cols"] == cols
    got = np.load(job["dir"] / f"vocab_{case}_out.npz")
    t = jnp.asarray(toks)
    logits, _ = jax.jit(lambda p, t: ref_model.forward(p, ref_cfg, t))(p, t)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, t: ref_model.loss_fn(p, ref_cfg, t)))(p, t)
    np.testing.assert_allclose(got["logits"], np.asarray(logits), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got["loss"], np.asarray(loss), rtol=1e-4,
                               atol=1e-4)
    cfg = reduced(get_config(arch), vocab=vocab)
    want = params_from_jax(jax.tree.map(np.asarray, grads), cfg, "cpu")
    paths = tree_paths(want)
    assert sorted(f"g{path}" for path in paths) == sorted(
        k for k in got.files if k.startswith("g/"))
    for path, w in zip(paths, tree_leaves(want)):
        w = w.numpy()
        err = np.abs(got[f"g{path}"] - w).max()
        assert err <= 1e-4 * max(np.abs(w).max(), 1e-12), (path, err)


def test_vocab_parallel_argmax_ties(job):
    res = job["mesh_2x2.json"]["argmax"]
    assert res["got"] == res["want"] == [2, 1, 5, 1, 6, 1, 5, 2, 3, 4]


# ------------------------------------------------- tensor-parallel blocks
RTOL, ATOL = 2e-4, 2e-5
# each cache leaf's dim over model at model = 2 (-1: whole), k / pos / v
CACHE_SPLIT = {"A": [2, 1, 2], "B": [1, 1, 1], "B ring": [1, 1, 1],
               "B whole ring": [-1, -1, -1], "C": [1, 1, 1], "xA": [2, 2],
               "xB": [1, 1], "xC": [1, 1]}


def _ref_inputs(run: str, cfg_name: str, **kw):
    cfg = J.block_config(cfg_name, ref_get_config, ref_reduced)
    arrays = J.block_inputs(run, cfg, **kw)
    p = {k[2:]: jnp.asarray(v) for k, v in arrays.items()
         if k.startswith("p/")}
    return cfg, arrays, p


def _ref_serve_block(run: str) -> dict:
    name, cross, window, length, t, steps = J.serve_spec(run)
    cfg, arrays, p = _ref_inputs(run, name, steps=steps, t=t)
    b = J.BLOCK_B
    if cross:
        shape = (b, cfg.memory_len, cfg.n_kv_heads, cfg.hd)
        cache = {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
    else:
        cache = ref_blocks.init_attention_cache(cfg, b, length, jnp.float32)
    memory = jnp.asarray(arrays["memory"]) if cross else None

    def step(prefill: bool):
        def run(p, x, pos, cache):
            ctx = ref_blocks.Ctx("prefill" if prefill else "decode", pos,
                                 memory, cache)
            return ref_blocks.apply_attention(p, x, cfg, ctx, window=window,
                                              cross=cross)
        return jax.jit(run)

    prefill, decode = step(True), step(False)
    out = {}
    for i in range(steps + 1):
        x = arrays["x"] if i == 0 else arrays["xd"][i - 1]
        pos = jnp.broadcast_to(jnp.arange(t, dtype=jnp.int32)[None], (b, t)) \
            if i == 0 else jnp.full((b, 1), t + i - 1, jnp.int32)
        y, cache = (prefill if i == 0 else decode)(p, jnp.asarray(x), pos,
                                                   cache)
        out[f"y{i}"] = np.asarray(y)
    out.update({f"cache/{k}": np.asarray(v) for k, v in cache.items()})
    return out


def _ref_train_block(run: str) -> dict:
    mlp = run == "mlp"
    cfg, arrays, p = _ref_inputs(run, "A" if mlp else run)

    def f(p, x):
        if mlp:
            return ref_blocks.apply_mlp(p, x)
        return ref_blocks.apply_attention(p, x, cfg, ref_blocks.Ctx("train"))[0]

    x = jnp.asarray(arrays["x"])
    gp, gx = jax.jit(jax.grad(lambda p, x: jnp.sum(f(p, x) ** 2),
                              (0, 1)))(p, x)
    out = {"y": np.asarray(jax.jit(f)(p, x)), "g/x": np.asarray(gx)}
    out.update({f"g/{k}": np.asarray(v) for k, v in gp.items()})
    return out


def _close_to_both(got, want: dict) -> None:
    """Every array of ``want`` (the reference's) against the mesh's and the
    one-process port's in ``got``; integers exactly."""
    for k, v in want.items():
        for who in ("mesh", "port"):
            a = got[f"{who}/{k}"]
            if v.dtype.kind in "iu":
                np.testing.assert_array_equal(a, v, err_msg=f"{who} {k}")
            else:
                np.testing.assert_allclose(a, v, rtol=RTOL, atol=ATOL,
                                           err_msg=f"{who} {k}")
        np.testing.assert_allclose(got[f"mesh/{k}"], got[f"port/{k}"],
                                   rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("run", list(J.SERVE_BLOCKS))
def test_tp_attention_prefill_decode(job, run):
    got = np.load(job["dir"] / f"block_serve {run}.npz")
    assert list(got["mesh/split"]) == CACHE_SPLIT[run]
    want = _ref_serve_block(run)
    assert len([k for k in want if k.startswith("y")]) == \
        J.serve_spec(run)[5] + 1
    _close_to_both(got, want)


@pytest.mark.parametrize("run", list(J.TRAIN_BLOCKS) + ["mlp"])
def test_tp_block_train_gradients(job, run):
    got = np.load(job["dir"] / f"block_train {run}.npz")
    want = _ref_train_block(run)
    # every weight's gradient comes back in the weight's own placement: the
    # split ones reduce-scattered over data only, the gathered ones (B's wk
    # and wv) reduce-scattered over both; q_norm and k_norm, replicated,
    # come back partial over data, and over model, since each rank
    # back-propagates through its own heads (A, B) or its own output
    # columns (C), which ``placed_like`` sums
    placed = [k for k in got.files if k.startswith("mesh/placed/")]
    assert len(placed) == len(want) - 2
    for k in placed:
        name = k.rsplit("/", 1)[-1]
        if name in ("q_norm", "k_norm"):
            assert str(got[f"mesh/gpl/{name}"][0]) == \
                "(Partial(sum), Partial(sum))", name
        else:
            assert bool(got[k][0]), name
    _close_to_both(got, want)


def test_tp_attention_refuses_plain_caches(job):
    # a ring's local shards cannot say that they are shards: attention
    # under tensor parallelism takes its caches placed, and raises on the
    # local tensors instead of attending over half a ring as if whole
    said = job["mesh_2x2.json"]["blocks"]["plain_caches"]
    assert "caches placed (DTensors)" in said, said


def test_tp_mlp_prefill_decode(job):
    got = np.load(job["dir"] / "block_mlp.npz")
    cfg, arrays, p = _ref_inputs("mlp", "A")
    want = {k: np.asarray(ref_blocks.apply_mlp(
        p, jnp.asarray(arrays[k] if k == "x" else arrays[k][0])))
        for k in ("x", "xd")}
    _close_to_both(got, want)


def _layer_collectives(job, layer: str) -> None:
    res = job["mesh_2x2.json"][f"{layer} layer collectives"]
    rec = res["record"]
    cfg = ref_reduced(ref_get_config(J.LAYERS[layer][0]))
    rows, t, d = res["rows"], res["t"], cfg.d_model
    # the attention's (the RG-LRU's) and the MLP's sums over model, of the
    # rank's rows
    assert rec["all-reduce_count"] == 2
    assert rec["all-reduce_bytes"] == 2 * rows * t * d * 4
    # the weights gathered over data only: each keeps its model shard; the
    # RG-LRU's conv output (rows, t, W / 2) gathered over model to its W
    # channels, which its dense gates read
    extra = {"attn": (0, 0),
             "rglru": (1, rows * t * int(cfg.rglru_expand * d) * 4)}[layer]
    # the 2-d weights, whose dims divide over data 2: attention's wq, wk,
    # wv, wo or the RG-LRU's wx, wy, conv, wgx, wga, wo, and the MLP's wi,
    # wg, wo (the norms and a_log are 1-d and replicated)
    n_data = {"attn": 7, "rglru": 9}[layer]
    assert res["data_gathers"] == n_data
    assert rec["all-gather_count"] == n_data + extra[0]
    assert rec["all-gather_bytes"] == res["data_gather_bytes"] + extra[1]
    assert rec["total_collective_bytes"] == \
        rec["all-reduce_bytes"] + rec["all-gather_bytes"]


def _no_collectives(job, layer: str) -> None:
    rec = job["mesh_1x1.json"][f"{layer} layer collectives"]["record"]
    assert rec["total_collective_bytes"] == 0
    assert sum(rec[f"{c}_count"] for c in ("all-reduce", "all-gather",
                                           "reduce-scatter",
                                           "all-to-all")) == 0


def test_tp_layer_collectives_on_2x2(job):
    _layer_collectives(job, "attn")


def test_tp_layer_collectives_on_1x1_none(job):
    _no_collectives(job, "attn")


def test_tp_rglru_layer_collectives_on_2x2(job):
    _layer_collectives(job, "rglru")


def test_tp_rglru_layer_collectives_on_1x1_none(job):
    _no_collectives(job, "rglru")


def test_tp_case_c_layer_collectives_on_2x2(job):
    """One reduced minicpm-2b layer at 3 heads (case C on 2 x 2: 24 of the
    48 q, k and v columns a rank), counted by hand: the three halo
    all-to-alls, each returning the two whole heads rank 0's columns
    touch; the attention's sum over ``wo``'s rows and the MLP's; the
    weights gathered over ``data`` only, no attention weight over
    ``model``."""
    res = job["mesh_2x2.json"]["attn C layer collectives"]
    rec = res["record"]
    cfg = J.layer_config("attn C", ref_get_config, ref_reduced)
    rows, t, d, hd = res["rows"], res["t"], cfg.d_model, cfg.hd
    assert cfg.n_heads % 2 and cfg.n_heads == cfg.n_kv_heads
    nc = cfg.n_heads * hd // 2
    touched = ((nc - 1) // hd + 1) * hd       # rank 0: heads 0 and 1
    assert rec["all-to-all_count"] == 3
    assert rec["all-to-all_bytes"] == 3 * rows * t * touched * 4
    assert rec["all-reduce_count"] == 2
    assert rec["all-reduce_bytes"] == 2 * rows * t * d * 4
    # wq, wk, wv, wo and the MLP's wi, wg, wo, over data alone
    assert res["data_gathers"] == 7
    assert rec["all-gather_count"] == 7
    assert rec["all-gather_bytes"] == res["data_gather_bytes"]
    assert rec["reduce-scatter_count"] == 0
    assert rec["total_collective_bytes"] == rec["all-reduce_bytes"] + \
        rec["all-gather_bytes"] + rec["all-to-all_bytes"]


def test_tp_xlstm_layer_collectives_on_2x2(job):
    """One reduced xlstm-350m layer (three mLSTM blocks and an sLSTM, no
    caches) on 2 x 2, counted by hand: each mLSTM all-gathers its ``u``
    (rows, t, w / 2) to ``w`` columns over ``model`` and sums its output
    over ``model``; the sLSTM reduce-scatters its output gate's partial
    product to its d / 2 channels and gathers its output (rows, t, d / 2)
    to d; the weights are gathered over ``data`` only; nothing moves
    between layouts without states."""
    res = job["mesh_2x2.json"]["xlstm layer collectives"]
    rec = res["record"]
    cfg = ref_reduced(ref_get_config("xlstm-350m"))
    rows, t, d = res["rows"], res["t"], cfg.d_model
    w = int(cfg.mlstm_expand * d)
    assert rec["all-reduce_count"] == 3
    assert rec["all-reduce_bytes"] == 3 * rows * t * d * 4
    assert rec["reduce-scatter_count"] == 1
    assert rec["reduce-scatter_bytes"] == rows * t * (d // 2) * 4
    # the mLSTM's wu, wg, wq, wk, wv, wi, wf, wo and the sLSTM's wz, wi,
    # wf, wo, up, down: every 2-d weight has a dim that data 2 divides
    assert res["data_gathers"] == 3 * 8 + 6
    assert rec["all-gather_count"] == res["data_gathers"] + 3 + 1
    assert rec["all-gather_bytes"] == res["data_gather_bytes"] + \
        3 * rows * t * w * 4 + rows * t * d * 4
    assert rec["all-to-all_count"] == 0
    assert rec["total_collective_bytes"] == rec["all-reduce_bytes"] + \
        rec["all-gather_bytes"] + rec["reduce-scatter_bytes"]


def test_tp_xlstm_layer_collectives_on_1x1_none(job):
    _no_collectives(job, "xlstm")


# ---------------------------------------------------------------- the RG-LRU
def _ref_rglru_inputs(**kw):
    return _ref_inputs("rglru", "B", **kw)


def test_tp_rglru_prefill_decode(job):
    got = np.load(job["dir"] / "block_serve rglru.npz")
    # conv (B, cw - 1, W) and h (B, W): their channels over model
    assert list(got["mesh/split"]) == [2, 1]
    cfg, arrays, p = _ref_rglru_inputs(steps=J.RGLRU_STEPS, t=J.RGLRU_T)
    cache = ref_blocks.init_rglru_cache(cfg, J.BLOCK_B, jnp.float32)

    def step(mode):
        return jax.jit(lambda p, x, c: ref_blocks.apply_rglru(
            p, x, cfg, ref_blocks.Ctx(mode, None, None, c)))

    prefill, decode = step("prefill"), step("decode")
    want = {}
    for i in range(J.RGLRU_STEPS + 1):
        x = arrays["x"] if i == 0 else arrays["xd"][i - 1]
        y, cache = (prefill if i == 0 else decode)(p, jnp.asarray(x), cache)
        want[f"y{i}"] = np.asarray(y)
    want.update({f"cache/{k}": np.asarray(v) for k, v in cache.items()})
    _close_to_both(got, want)


def test_tp_rglru_train_gradients(job):
    got = np.load(job["dir"] / "block_train rglru.npz")
    cfg, arrays, p = _ref_rglru_inputs()

    def f(p, x):
        return ref_blocks.apply_rglru(p, x, cfg, ref_blocks.Ctx("train"))[0]

    x = jnp.asarray(arrays["x"])
    gp, gx = jax.jit(jax.grad(lambda p, x: jnp.sum(f(p, x) ** 2),
                              (0, 1)))(p, x)
    want = {"y": np.asarray(jax.jit(f)(p, x)), "g/x": np.asarray(gx)}
    want.update({f"g/{k}": np.asarray(v) for k, v in gp.items()})
    # the split weights' and the gathered ones' gradients come back placed;
    # a_log, replicated, partial over data and over model (each rank
    # back-propagates through its own channels), which ``placed_like`` sums
    for k in gp:
        if k == "a_log":
            assert str(got["mesh/gpl/a_log"][0]) == \
                "(Partial(sum), Partial(sum))"
        else:
            assert bool(got[f"mesh/placed/{k}"][0]), k
    _close_to_both(got, want)


def test_tp_rglru_refuses_plain_caches(job):
    said = job["mesh_2x2.json"]["blocks"]["plain_rglru_caches"]
    assert "caches placed (DTensors)" in said, said
