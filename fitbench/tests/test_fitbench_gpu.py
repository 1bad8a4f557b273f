"""On the card: each cell's command end to end, as the check runs it, with a
short window."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import ROOT

CELLS = [c["name"] for c in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_command_prints_a_correct_result_on_the_card(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, "fitbench/run.py", "--workload", workload,
         "--seed", "4294967311", "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], proc.stderr[-2000:]
    assert result["device"]["platform"] == "gpu"
