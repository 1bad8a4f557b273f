"""The port's dry run (``repro_torch.launch.dryrun``):
``tests/test_dryrun_cell.py``'s assertions on the port's CLI, in a
subprocess (the fake process group of 512 ranks is global to a process),
on the same cell: xlstm-350m decode_32k on the multi-pod mesh, whose
per-rank flops are the count written out from its config (its rows, the
xLSTM products split over ``model``, its share of the vocabulary's
columns) and whose collectives are those the split dispatches; a
long_500k cell of a full-attention architecture, recorded as skipped with
the reference's reason; and internlm2-1.8b's prefill_32k on the single-pod
mesh, whose per-rank flops are the count written out from its config: the
products split over ``model`` (q, o, the MLP, the local heads' attention,
and the last position's logits over the vocabulary's columns) over both
mesh axes, the rest (k and v, whose 8 kv heads do not split over 16) over
``data`` alone; and whose all-reduces are the two sums over ``model`` a
layer, the embedding lookup's sum and the greedy pick's combine; and under
``zero3``, recurrentgemma-9b's prefill and internlm2-1.8b's decode batches
over 1,024 positions at full width count a rank's ``2d`` flops, with caches
of the same bytes."""
import json
import os
import pathlib
import subprocess
import sys

import pytest

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.configs import shape_applicable as ref_shape_applicable
from repro_torch.launch.dryrun import run_cell

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _dryrun(tmp_path, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args, "--out",
         str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stdout + res.stderr
    return res


def test_dryrun_cell_multipod(tmp_path):
    res = _dryrun(tmp_path, "--arch", "xlstm-350m", "--shape", "decode_32k",
                  "--multi-pod")
    rec = json.loads(
        (tmp_path / "xlstm-350m__decode_32k__pod2x16x16.json").read_text())
    assert rec["status"] == "ok"
    assert rec["n_devices"] == 512
    assert rec["jaxpr_flops_global"] > 0
    assert rec["collectives"]["wire_bytes"] > 0
    assert rec["memory"]["temp_size_in_bytes"] > 0
    # one rank's count, written out: its 128 / 32 rows of the global batch,
    # the xLSTM products split over model 16, and of the unembedding (2 B d
    # V) its share of the vocabulary's columns, 50,304 / 16
    cfg, shape = ref_get_config("xlstm-350m"), REF_SHAPES["decode_32k"]
    d, h, tp, dp = cfg.d_model, cfg.n_heads, 16, 32
    w, f = int(cfg.mlstm_expand * d), int(cfg.slstm_proj * d)
    hd = w // h
    b = shape.global_batch // dp
    assert tp % h == 0 and f % tp != 0 and cfg.vocab % tp == 0
    nv = hd // (tp // h)            # a quarter of one head's value rows
    blocks = [bt for unit, r in cfg.stacks for _ in range(r) for bt in unit]
    mlstm = 2 * b * (2 * d * w // tp        # wu, wg: column shards
                     + 3 * w * w // tp      # wq, wk, wv on the gathered u
                     + 2 * w                # wi, wf: the rank's one head
                     + nv * hd + hd         # C q on its value rows, n . q
                     + w // tp * d)         # wo: its rows
    slstm = 2 * b * (4 * d * d // tp        # wz, wi, wf: its channels; wo:
                     + 2 * d * f)           # its rows; up, down whole
    unembed = 2 * shape.global_batch * d * cfg.vocab
    assert rec["cost"]["flops"] == (blocks.count("mlstm") * mlstm
                                    + blocks.count("slstm") * slstm
                                    + unembed // (dp * tp))
    assert rec["cost"]["flops"] < rec["jaxpr_flops_global"] / dp
    # what the split dispatches: an all-reduce a mLSTM (its output), the
    # embedding lookup's and the greedy pick's; a reduce-scatter a sLSTM
    # (its output gate); five all-to-alls a mLSTM moving its states between
    # their placement and its quarter head (C and n in and out, m out: m
    # is whole as placed, and a rank takes its head's without a move)
    coll = rec["collectives"]
    assert coll["all-reduce_count"] == blocks.count("mlstm") + 2
    assert coll["reduce-scatter_count"] == blocks.count("slstm")
    assert coll["all-to-all_count"] == 5 * blocks.count("mlstm")
    assert rec["memory"]["alias_size_in_bytes"] > 0
    assert rec["compile_s"] == 0.0
    assert "[ok] xlstm-350m__decode_32k__pod2x16x16" in res.stdout


def test_long500k_full_attention_cell_skipped(tmp_path):
    rec = run_cell("internlm2-1.8b", "long_500k", True, tmp_path)
    want = ref_shape_applicable(ref_get_config("internlm2-1.8b"),
                                "long_500k")
    assert want[0] is False
    assert rec["status"] == "skipped" and rec["reason"] == want[1]
    saved = json.loads((tmp_path / "internlm2-1.8b__long_500k__pod2x16x16"
                        ".json").read_text())
    assert saved == rec


def test_tensor_parallel_prefill_flops_per_rank(tmp_path):
    _dryrun(tmp_path, "--arch", "internlm2-1.8b", "--shape", "prefill_32k")
    rec = json.loads((tmp_path / "internlm2-1.8b__prefill_32k__pod16x16"
                      ".json").read_text())
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    cfg, shape = ref_get_config("internlm2-1.8b"), REF_SHAPES["prefill_32k"]
    d, h, kv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                       cfg.d_ff)
    dp = tp = 16
    b, t = shape.global_batch, shape.seq_len
    layers = sum(r * len(unit) for unit, r in cfg.stacks)
    assert h % tp == 0 and kv % tp != 0          # case B: q split, kv whole
    assert cfg.vocab % tp == 0                   # the vocabulary splits
    split = (layers * (2 * b * t * d * h * hd       # q
                       + 4 * b * h * t * t * hd     # flash: 4 B H Tq S hd
                       + 2 * b * t * h * hd * d     # o
                       + 3 * 2 * b * t * d * f)     # wi, wg, wo
             + 2 * b * d * cfg.vocab)               # last position's logits
    rest = layers * 2 * 2 * b * t * d * kv * hd     # k, v
    assert rec["cost"]["flops"] == split // (dp * tp) + rest // dp
    assert rec["cost"]["flops"] < rec["jaxpr_flops_global"] / dp
    # one rank's collectives: the two sums over model a layer, the
    # embedding lookup's sum and the greedy pick's combine, no more
    assert rec["collectives"]["all-reduce_count"] == 2 * layers + 2


def test_tensor_parallel_prefill_flops_per_rank_case_c(tmp_path):
    """minicpm-2b's 36 heads do not divide over model 16 (case C): rank 0
    projects its 144 of the 2,304 q, k and v columns and its rows of
    ``wo``, runs flash over the three heads its columns touch, its MLP
    share, and the last position's logits over the whole vocabulary
    (122,753 does not divide); no attention weight is gathered over
    ``model``: the halo moves q, k and v (three all-to-alls a layer) and
    the ring's k and v to their slots (two)."""
    _dryrun(tmp_path, "--arch", "minicpm-2b", "--shape", "prefill_32k")
    rec = json.loads((tmp_path / "minicpm-2b__prefill_32k__pod16x16"
                      ".json").read_text())
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    cfg, shape = ref_get_config("minicpm-2b"), REF_SHAPES["prefill_32k"]
    d, h, kv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                       cfg.d_ff)
    dp = tp = 16
    b, t = shape.global_batch, shape.seq_len
    layers = sum(r * len(unit) for unit, r in cfg.stacks)
    assert h % tp and (h * hd) % tp == 0 and (kv * hd) % tp == 0
    assert cfg.vocab % tp and f % tp == 0
    nc, nkc = h * hd // tp, kv * hd // tp
    touched = (nc - 1) // hd + 1                    # rank 0: heads 0, 1, 2
    assert touched == 3
    rows = b // dp
    flops = (layers * (2 * rows * t * d * (nc + 2 * nkc)   # q, k, v columns
                       + 4 * rows * touched * t * t * hd   # flash
                       + 2 * rows * t * nc * d             # wo's rows
                       + 3 * 2 * rows * t * d * (f // tp))  # wi, wg, wo
             + 2 * rows * d * cfg.vocab)            # last position's logits
    assert rec["cost"]["flops"] == flops
    assert flops <= 8.598e13
    # one rank's collectives: the sums over model of attention and the
    # MLP a layer (the whole vocabulary needs no lookup sum or pick
    # combine), five all-to-alls a layer
    coll = rec["collectives"]
    assert coll["all-reduce_count"] == 2 * layers
    assert coll["all-to-all_count"] == 5 * layers


# One rank of the single-pod mesh (a fake group of 256) traces a cell under
# "2d" and "zero3" and prints its flops and its caches' bytes a policy.
_POLICY_CELLS = """
import json, sys
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.launch.dryrun import fake_group, local_bytes, trace_step
from repro_torch.launch.mesh import distribute_tree, make_production_mesh
from repro_torch.launch.specs import make_step_and_specs
arch, kind, seq, batch = sys.argv[1:]
fake_group(256)
mesh = make_production_mesh()
out = {}
for policy in ("2d", "zero3"):
    step, args, in_pl, _, _ = make_step_and_specs(
        get_config(arch), ShapeSpec(kind, int(seq), int(batch), kind), mesh,
        policy=policy)
    placed = tuple(distribute_tree(a, p, mesh) for a, p in zip(args, in_pl))
    _, flops, coll, _ = trace_step(step, placed)
    out[policy] = {"flops": flops, "cache_bytes": local_bytes(placed[-1]),
                   "all_to_all": coll["all-to-all_count"]}
print(json.dumps(out))
"""


@pytest.mark.parametrize("arch,kind,batch", [
    ("recurrentgemma-9b", "prefill", 32), ("internlm2-1.8b", "decode", 128)])
def test_zero3_serving_flops_per_rank_equal_2d(arch, kind, batch):
    """prefill_32k's and decode_32k's batches over 1,024 positions at full
    width on the single-pod mesh: neither batch divides the 256 ranks, so
    under ``zero3`` ``model`` carries no rows and splits the products on
    views of the gathered weights, and a rank counts the flops it counts
    under ``2d``, its caches placed by ``cache_spec`` with the same bytes;
    no cache moves between layouts."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-c", _POLICY_CELLS, arch, kind, "1024",
         str(batch)], capture_output=True, text=True, timeout=300, env=env,
        cwd=ROOT)
    assert res.returncode == 0, res.stdout + res.stderr
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["zero3"]["flops"] == got["2d"]["flops"] > 0, got
    assert got["zero3"]["cache_bytes"] == got["2d"]["cache_bytes"] > 0, got
    assert got["zero3"]["all_to_all"] == got["2d"]["all_to_all"], got

