"""The port's collective accounting (``repro_torch.launch.hlo_analysis``):
the reference's HLO-text parser, copied, under the reference's own three
tests (``tests/test_launch.py``) and against the reference module on the
same text; and the port's accountant, ``trace_collectives``, on a tiny
step on 2 x 2 ``gloo`` ranks (``tests/_torch_collectives_job.py``, one
subprocess) against a hand count."""
import json
import os
import subprocess
import sys
from pathlib import Path

from repro.launch import hlo_analysis as ref
from repro_torch.launch.hlo_analysis import (analyze_collectives,
                                             collective_record, op_kind,
                                             shape_bytes)

ROOT = Path(__file__).resolve().parents[1]
JOB = ROOT / "tests" / "_torch_collectives_job.py"

SYNTHETIC = """
cond.1 (arg: (s32[], f32[4])) -> pred[] {
  %c = s32[] constant(12)
  ROOT %cmp = pred[] compare(%iter, %c), direction=LT
}

body.1 (arg: (s32[], f32[4])) -> (s32[], f32[4]) {
  %ag = f32[64,128] all-gather(%w), dimensions={0}
  %ar = f32[32,32] all-reduce(%x), to_apply=%add
}

ENTRY main (p: f32[4]) -> f32[4] {
  %w = (s32[], f32[4]) while(%t), condition=%cond.1, body=%body.1
  %ar2 = bf16[8] all-reduce(%y), to_apply=%add
}
"""


def test_shape_bytes():
    assert shape_bytes("bf16[16,1024]") == 16 * 1024 * 2
    assert shape_bytes("(f32[8,8], s32[4])") == 8 * 8 * 4 + 4 * 4
    assert shape_bytes("pred[100]") == 100


def test_hlo_analysis_synthetic():
    res = analyze_collectives(SYNTHETIC)
    assert res["all-gather_bytes"] == 12 * 64 * 128 * 4
    assert res["all-reduce_bytes"] == 12 * 32 * 32 * 4 + 8 * 2
    assert res["total_collective_bytes_raw"] == \
        64 * 128 * 4 + 32 * 32 * 4 + 8 * 2
    assert res["wire_bytes"] == 2 * res["all-reduce_bytes"] + \
        res["all-gather_bytes"]
    assert res == ref.analyze_collectives(SYNTHETIC)


def test_hlo_promoted_allreduce_halved():
    hlo = """
ENTRY main (p: f32[4]) -> f32[4] {
  %ar = f32[16] all-reduce(%y), to_apply=%add.clone_promoted
}
"""
    res = analyze_collectives(hlo)
    assert res["all-reduce_bytes"] == 16 * 4 // 2
    assert res == ref.analyze_collectives(hlo)


def test_op_kinds():
    assert op_kind("_c10d_functional", "all_gather_into_tensor") == \
        "all-gather"
    assert op_kind("_c10d_functional", "reduce_scatter_tensor") == \
        "reduce-scatter"
    assert op_kind("_c10d_functional", "all_reduce") == "all-reduce"
    assert op_kind("_c10d_functional", "all_to_all_single") == "all-to-all"
    assert op_kind("c10d", "allreduce_") == "all-reduce"
    assert op_kind("c10d", "_allgather_base_") == "all-gather"
    assert op_kind("_c10d_functional", "wait_tensor") is None
    assert op_kind("aten", "all_reduce") is None


def test_record_keys_match_reference():
    rec = collective_record([("all-reduce", 40), ("all-gather", 384)])
    assert set(rec) == set(ref.analyze_collectives(SYNTHETIC))
    assert rec["wire_bytes"] == 2 * 40 + 384
    assert rec["total_collective_bytes"] == \
        rec["total_collective_bytes_raw"] == 424


def test_accountant_on_2x2_ranks_hand_count(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, str(JOB), str(tmp_path)],
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads((tmp_path / "collectives.json").read_text())
    rec = res["record"]
    # the step's own results: the collectives really ran
    # (the all-to-all: 2 values from each of ranks 0 to 3)
    assert res["out"] == [[8, 12], [4, 6], [4, 6], 96.0, 48.0, 48.0, 40.0,
                          12.0]
    assert (rec["all-gather_count"], rec["all-gather_bytes"]) == (1, 384)
    assert (rec["all-reduce_count"], rec["all-reduce_bytes"]) == \
        (2, 96 + 40)
    assert (rec["reduce-scatter_count"], rec["reduce-scatter_bytes"]) == \
        (1, 96)
    assert (rec["all-to-all_count"], rec["all-to-all_bytes"]) == (1, 32)
    assert rec["collective-permute_count"] == 0
    assert rec["total_collective_bytes"] == 384 + 136 + 96 + 32
    assert rec["wire_bytes"] == 2 * 136 + 384 + 96 + 32
