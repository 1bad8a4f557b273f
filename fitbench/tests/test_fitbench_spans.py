"""The metrics that read the program's spans: each reported in exactly the
cells its ``workloads`` lists, and the LSM channels the older metrics read
kept at their row widths."""
from __future__ import annotations

import json

import pytest
import torch

from conftest import ROOT, SEED, SMALL
from fitbench import harness

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
SPAN_METRICS = {"service.route_ms", "engine.host_ms",
                "lsm.compaction_fit_share"}
# the channels lsm.spill_ms, lsm.compaction_share and lsm.read_amp read
LSM_WIDTHS = {"lsm.spill": 2, "lsm.compaction": 3, "lsm.read_amp": 1}
_RUNS: dict[str, tuple] = {}


def traced(workload: str):
    """One small traced CPU run a cell (cached), with the service's
    monitor kept for the test."""
    if workload not in _RUNS:
        seen = {}

        def factory(config, column, device, monitor):
            seen["monitor"] = monitor
            mod = harness.load_file(
                harness.HERE / "services" / f"{config['service']}.py",
                f"fitbench_service_{config['service']}")
            return mod.Service(config, column, device, monitor)

        small = SMALL[workload]
        if workload == "weblogs-16m-lsm.mix":
            # reads of 8,192 bring 430 inserts each and a memtable of 256
            # compacts after 1,024: a compaction within three reads,
            # however slowly a loaded CPU runs the traced window
            small = {"config": {**small["config"], "memtable_capacity": 256},
                     "mix": {"read": {"size": 8192}}}
        # one intra-op thread: beside the other test workers, more threads
        # slow the window's reads twentyfold
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            result, lines = harness.run_cell(
                ROOT, workload, SEED, 3.0, True, device="cpu",
                overrides=small, service_factory=factory)
        finally:
            torch.set_num_threads(threads)
        _RUNS[workload] = (result, lines, seen["monitor"])
    return _RUNS[workload]


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_span_metrics_are_reported_in_exactly_their_cells(workload):
    result, lines, mon = traced(workload)
    assert result["correct"], lines
    counts = {ch: mon.count(ch) for ch in mon.channels()}
    want = {m["name"] for m in harness.metrics_of(SPEC, workload, True)}
    assert SPAN_METRICS & want          # each cell reads one at least
    assert set(result["metrics"]) & SPAN_METRICS == SPAN_METRICS & want, \
        (result["attempted"], counts)
    for name in SPAN_METRICS & want:
        assert result["metrics"][name]["value"] > 0
    share = result["metrics"].get("lsm.compaction_fit_share")
    if share is not None:
        assert share["value"] <= 1.0    # a fit lies inside its compaction


def test_the_span_metrics_name_a_layer_and_their_cells():
    cells = {c["name"] for c in SPEC["workloads"]}
    got = {m["name"]: m for m in SPEC["per_layer"]
           if m["name"] in SPAN_METRICS}
    assert set(got) == SPAN_METRICS
    for m in got.values():
        assert m["source"] == "program_span" and m["moves"] == "keys_per_s"
        assert set(m["workloads"]) <= cells


@pytest.mark.parametrize("workload", ["weblogs-16m-lsm.mix",
                                      "weblogs-16m-lsm.ingest"])
def test_lsm_channels_keep_their_row_widths(workload):
    _, _, mon = traced(workload)
    for name, width in LSM_WIDTHS.items():
        rows = mon.channel(name)
        if name == "lsm.read_amp" and workload.endswith("ingest"):
            assert not rows.size        # the ingest reads nothing
            continue
        assert rows.shape[0] > 0 and rows.shape[1] == width, name
