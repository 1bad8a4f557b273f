"""The port's dry run (``repro_torch.launch.dryrun``):
``tests/test_dryrun_cell.py``'s assertions on the port's CLI, in a
subprocess (the fake process group of 512 ranks is global to a process),
on the same cell: xlstm-350m decode_32k on the multi-pod mesh; and a
long_500k cell of a full-attention architecture, recorded as skipped with
the reference's reason."""
import json
import os
import pathlib
import subprocess
import sys

from repro.configs import get_config as ref_get_config
from repro.configs import shape_applicable as ref_shape_applicable
from repro_torch.launch.dryrun import run_cell

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_dryrun_cell_multipod(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "xlstm-350m", "--shape", "decode_32k", "--multi-pod", "--out",
         str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stdout + res.stderr
    rec = json.loads(
        (tmp_path / "xlstm-350m__decode_32k__pod2x16x16.json").read_text())
    assert rec["status"] == "ok"
    assert rec["n_devices"] == 512
    assert rec["jaxpr_flops_global"] > 0
    assert rec["collectives"]["wire_bytes"] > 0
    assert rec["memory"]["temp_size_in_bytes"] > 0
    # one rank's count: its 128 / 32 rows of the global batch
    assert rec["cost"]["flops"] * 32 == rec["jaxpr_flops_global"]
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
