"""The port's dry-run cells (``repro_torch.launch.specs``):
``tests/test_launch.py::test_input_specs_all_cells`` and
``::test_long500k_skips_documented`` on the port, the specs' shapes against
the reference's, and ``make_step_and_specs`` for a reduced config of
each family (dense, recurrent, MoE, xLSTM, vision, audio) on a one-rank (1, 1) ``gloo`` mesh: train, prefill
and decode bound under activation sharding, their arguments placed on
meta, traced, with outputs placed as the output placements say and the
same flop count as the step without a mesh; and the placements under
every policy: every cache leaf (attention's, the RG-LRU's and the xLSTM's
states) keeps the ``model`` entry ``cache_spec`` gives it, and the next
tokens and decode's positions are the ``2d`` pool's rows;
recurrentgemma-9b's and xlstm-350m's states at full size on an abstract
(16, 16) mesh."""
import jax
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro.configs import get_config as ref_get_config
from repro.launch.specs import input_specs as ref_input_specs
from repro_torch.configs import (ARCHS, SHAPES, ShapeSpec, get_config,
                                 reduced, shape_applicable)
from repro_torch.launch.flops_count import count_flops
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import distribute_tree, make_host_mesh
from repro_torch.launch.specs import (cache_shapes, input_specs,
                                      make_step_and_specs, param_shapes)
from repro_torch.tree import tree_leaves, tree_paths

_DTYPES = {"int32": torch.int32, "bfloat16": torch.bfloat16,
           "float32": torch.float32}


def test_input_specs_all_cells():
    """Every runnable (arch x shape) produces well-formed meta trees."""
    n = 0
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape, spec in SHAPES.items():
            ok, _ = shape_applicable(cfg, shape)
            if not ok:
                continue
            kind, shapes = input_specs(arch, shape)
            n += 1
            assert all(t.device.type == "meta" for t in tree_leaves(shapes))
            if kind == "train":
                assert shapes["batch"]["tokens"].shape == \
                    (spec.global_batch, spec.seq_len)
            elif kind == "prefill":
                assert shapes["tokens"].shape == (spec.global_batch,
                                                  spec.seq_len)
                assert len(tree_leaves(shapes["caches"])) > 0
            else:
                assert shapes["tokens"].shape == (spec.global_batch, 1)
                assert shapes["pos"].shape == (spec.global_batch,)
    assert n == 34          # 40 cells - 6 documented skips


def test_long500k_skips_documented():
    skipped = [a for a in ARCHS
               if not shape_applicable(get_config(a), "long_500k")[0]]
    assert sorted(skipped) == sorted([
        "internlm2-1.8b", "minicpm-2b", "arctic-480b", "qwen3-moe-235b-a22b",
        "llama-3.2-vision-11b", "whisper-medium"])


def _layer_shapes(tree) -> dict:
    """Each cache leaf's shape, keyed by its path without the layer index
    (the port keeps one dict per layer where the reference stacks them)."""
    out = {}
    for path, leaf in zip(tree_paths(tree), tree_leaves(tree)):
        key = "/".join(k for k in path.split("/") if not k.isdigit())
        out.setdefault(key, []).append(tuple(leaf.shape))
    return out


@pytest.mark.parametrize("arch", ("internlm2-1.8b", "recurrentgemma-9b",
                                  "whisper-medium"))
def test_input_specs_match_reference(arch):
    """Every input leaf's shape and type is the reference's; a cache leaf
    is one layer of the reference's stacked leaf."""
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        kind, got = input_specs(arch, shape)
        ref_kind, want = ref_input_specs(arch, shape)
        assert kind == ref_kind and set(got) == set(want)
        for key, w in want.items():
            if key == "caches":
                continue
            ports = dict(zip(tree_paths(got[key]), tree_leaves(got[key])))
            refs = {"".join(f"/{k.key}" for k in path): wl for path, wl in
                    jax.tree_util.tree_leaves_with_path(w)}
            assert set(ports) == set(refs)
            for path, wl in refs.items():
                assert tuple(ports[path].shape) == wl.shape
                assert ports[path].dtype == _DTYPES[str(wl.dtype)]
        if "caches" in want:
            ports = _layer_shapes(got["caches"])
            for path, wl in jax.tree_util.tree_leaves_with_path(
                    want["caches"]):
                key = "/" + "/".join(k.key for k in path)
                assert ports[key] == [wl.shape[1:]] * wl.shape[0], key


@pytest.fixture(scope="module")
def mesh():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield make_host_mesh()
    finally:
        dist.destroy_process_group()


FAMILIES = ("internlm2-1.8b", "recurrentgemma-9b", "qwen3-moe-235b-a22b",
            "xlstm-350m", "llama-3.2-vision-11b", "whisper-medium")


@pytest.mark.parametrize("kind", ("train", "prefill", "decode"))
@pytest.mark.parametrize("arch", FAMILIES)
def test_step_traces_on_meta_under_1x1_mesh(mesh, arch, kind):
    cfg = reduced(get_config(arch))
    shape = ShapeSpec("test", 16, 2, kind)
    step, args, in_pl, out_pl, donate = make_step_and_specs(cfg, shape,
                                                            mesh)
    assert donate == {"train": (0, 1), "prefill": (2,),
                      "decode": (3,)}[kind]
    placed = tuple(distribute_tree(a, p, mesh) for a, p in zip(args, in_pl))
    assert all(isinstance(t, DTensor) and t.to_local().device.type == "meta"
               for t in tree_leaves(placed) if t.dim() > 0)
    ctx = torch.enable_grad() if kind == "train" else torch.no_grad()
    with ctx:
        flops = count_flops(step, *placed)
        out = step(*placed)
    bare, bare_args, _, _, _ = make_step_and_specs(cfg, shape, None)
    with ctx:
        assert flops == count_flops(bare, *bare_args) > 0
    if kind == "train":
        params, opt, metrics = out
        for new, old in zip(tree_leaves((params, opt)),
                            tree_leaves(placed[:2])):
            assert type(new) is type(old) and new.shape == old.shape
            if isinstance(old, DTensor):
                assert new.placements == old.placements
        assert sorted(metrics) == ["grad_norm", "loss", "lr"]
        assert all(m.dim() == 0 for m in metrics.values())
        return
    nxt, caches = out
    assert isinstance(nxt, DTensor) and nxt.shape == (2,)
    assert list(nxt.placements) == out_pl[0]
    cache_arg = placed[2] if kind == "prefill" else placed[3]
    for new, old in zip(tree_leaves(caches), tree_leaves(cache_arg)):
        assert isinstance(new, DTensor)
        assert new.shape == old.shape and new.placements == old.placements


def test_param_shapes_are_bf16_meta():
    p = param_shapes(reduced(get_config("gemma3-12b")))
    assert all(t.device.type == "meta" and t.dtype == torch.bfloat16
               for t in tree_leaves(p))


def test_reference_configs_are_the_ports():
    for arch in ARCHS:
        assert get_config(arch).d_model == ref_get_config(arch).d_model


@pytest.mark.parametrize("arch", FAMILIES)
def test_cache_placements_keep_attention_model_entries(mesh, arch):
    """Under every policy the caches are placed by ``cache_spec``, in and
    out, and the next tokens and decode's positions over the ``2d`` pool's
    rows, as the reference's ``make_step_and_specs`` places them; the input
    tokens by the policy's own batch spec."""
    cfg = reduced(get_config(arch))
    shape = ShapeSpec("test", 16, 2, "decode")
    model = mesh.mesh_dim_names.index("model")
    for policy in ("2d", "zero3", "tp"):
        _, args, in_pl, out_pl, _ = make_step_and_specs(cfg, shape, mesh,
                                                         policy=policy)
        caches, pls = args[3], in_pl[3]
        assert out_pl[1] is pls
        specs = tree_leaves(sh.cache_shardings(mesh, caches, 2))
        leaves = list(zip(tree_paths(caches), specs, _placements(pls)))
        assert len(leaves) == len(tree_leaves(caches))
        for path, spec, pl in leaves:
            assert pl == sh.to_placements(spec, mesh), (policy, path)
            # kv heads or length; the recurrent states' channels, the
            # mLSTM's value rows, k entries or heads
            assert pl[model].is_shard(), (policy, path)
        rows = sh.to_placements(sh.batch_spec(mesh, 2, 1), mesh)
        assert out_pl[0] == in_pl[2] == rows, policy
        assert in_pl[1] == sh.to_placements(
            sh.batch_spec(mesh, 2, 2, policy), mesh), policy


@pytest.mark.parametrize("arch", ("recurrentgemma-9b", "xlstm-350m"))
def test_recurrent_state_model_entries(arch):
    """``cache_spec``'s specs, which the bound steps place the caches by
    under every policy, on the single-pod mesh (data 16, model 16) at
    decode_32k's batch of 128: the RG-LRU's ``conv`` (B, cw - 1, W) and ``h`` (B, W) and the sLSTM's
    ``c``, ``n``, ``m`` (B, d) keep their channels over ``model``, the
    mLSTM's ``C`` (B, H, hd_v, hd_k) every head's value rows and ``n`` (B,
    H, hd_k) every head's k entries; its ``m`` (B, 4 heads) has none, since
    16 does not divide 4."""
    mesh = sh.MeshShape(("data", "model"), (16, 16))
    caches = cache_shapes(get_config(arch), 128, 16)
    names = set()
    want = {"C": sh.P(("data",), None, "model", None),
            "n": sh.P(("data",), None, "model"),
            "m": sh.P(("data",), None)}
    paths = tree_paths(caches)
    slstm = {p.rsplit("/", 1)[0] for p in paths if p.endswith("/c")}
    for path, spec in zip(paths, tree_leaves(
            sh.cache_shardings(mesh, caches, 128))):
        block, name = path.rsplit("/", 1)
        names.add(name)
        if name in ("conv", "h") or block in slstm:
            assert spec == sh.P(("data",), *[None] * (len(spec) - 2),
                                "model"), path
        elif name in want:
            assert spec == want[name], path
    assert names == ({"conv", "h", "k", "v", "pos"}
                     if arch == "recurrentgemma-9b"
                     else {"C", "n", "m", "c"})


def _placements(tree) -> list:
    """The placement lists of a placements tree, in leaf order."""
    if isinstance(tree, dict):
        return [p for v in tree.values() for p in _placements(v)]
    if isinstance(tree, list) and tree and not isinstance(tree[0], (dict,
                                                                    list)):
        return [tree]
    return [p for v in tree for p in _placements(v)]
