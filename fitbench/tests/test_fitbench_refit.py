"""``sharded.refit_card_share``: the share of the in-place publishes' dirty
runs re-fitted on the card.  The reader on synthetic span rows, the CPU
twins' traced mix (every run fitted on the host), and a short traced
``mix_epoch`` run on the card."""
from __future__ import annotations

import json
import subprocess
import sys
from types import SimpleNamespace

import pytest

from conftest import ROOT
from fitbench import harness
from test_fitbench_inplace import MIX, run_small

NAME = "sharded.refit_card_share"


def _reader():
    return harness.load_file(harness.HERE / "metrics" / f"{NAME}.py",
                             f"fitbench_metric_{NAME}")


def test_refit_card_share_reads_the_flush_rows_second_tag():
    """Runs fitted on the card over runs re-fitted, summed over the window's
    ``tree.flush`` rows; None without a Monitor, without rows, or where the
    rows carry no second tag (a program whose flush fits on the host)."""
    from repro_torch.index.telemetry import Monitor
    reader = _reader()
    assert reader.read(SimpleNamespace(monitor=None)) is None
    mon = Monitor()
    assert reader.read(SimpleNamespace(monitor=mon)) is None
    for refit, on_card in ((30, 30), (10, 0), (0, 0)):
        with mon.span("tree.flush", refit, on_card):
            pass
    assert reader.read(SimpleNamespace(monitor=mon)) == 0.75
    old = Monitor()
    with old.span("tree.flush", 30):
        pass
    assert reader.read(SimpleNamespace(monitor=old)) is None


def test_traced_mix_on_the_cpu_twins_fits_every_run_on_the_host():
    result, lines = run_small(MIX, seconds=3.0, traced=True)
    assert result["correct"], lines
    assert result["metrics"][NAME]["value"] == 0.0


def test_the_metric_names_its_cell_and_layer():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    per_layer = {m["name"]: m for m in spec["per_layer"]}
    m = per_layer[NAME]
    assert m["workloads"] == [MIX] and m["moves"] == "keys_per_s"
    assert m["source"] == "program_span" and m["better"] == "higher"
    assert m["layer"] == per_layer["sharded.publish_share"]["layer"]


@pytest.mark.gpu
def test_traced_mix_epoch_refits_every_dirty_run_on_the_card():
    """The in-place mix's publishes re-fit on the card: the traced run reads
    ``sharded.refit_card_share`` 1.0; untraced it reports no per-layer
    metric."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    got = {}
    for trace in (1, 0):
        proc = subprocess.run(
            [sys.executable, "fitbench/run.py", "--workload", MIX,
             "--seed", "4294967329", "--seconds", "6", "--trace", str(trace)],
            cwd=ROOT, capture_output=True, text=True, timeout=900)
        assert proc.returncode == 0, proc.stderr[-2000:]
        got[trace] = json.loads(proc.stdout.strip().splitlines()[-1])
        assert got[trace]["correct"], proc.stderr[-2000:]
    assert got[1]["metrics"][NAME]["value"] == 1.0
    assert NAME not in got[0]["metrics"]
