"""``service.one_launch_share``: a traced CPU run of the in-place probe,
whose reads span nine shards, reads 1.0 (one engine call a read); the
reader finds nothing in ``service.route`` rows without the engine-call tag
or without a read past one shard; and its ``BENCHMARK.json`` entry."""
from __future__ import annotations

import json
import types

import pytest
import torch

from conftest import ROOT, SEED
from fitbench import harness

PROBE = "weblogs-16m-inplace.probe"
NAME = "service.one_launch_share"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CONFIG = json.loads((ROOT / "fitbench/configs/weblogs-16m-inplace.json")
                    .read_text())
# the full column's plan (nine shards) over 2^16 keys
SMALL = {"config": {
    "keys": {"dataset": "weblogs_like", "n": 2 ** 16, "domain": 2 ** 16},
    "fit_spec": {**CONFIG["fit_spec"], "n_keys_hint": CONFIG["keys"]["n"]}},
    "mix": {"read": {"size": 8192}}}


def _reader():
    return harness.load_file(harness.HERE / "metrics" / f"{NAME}.py",
                             "fitbench_metric_one_launch")


def test_traced_inplace_probe_reads_one_engine_call_a_read():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)       # beside other test workers
    try:
        result, lines = harness.run_cell(ROOT, PROBE, SEED, 1.5, True,
                                         device="cpu", overrides=SMALL)
    finally:
        torch.set_num_threads(threads)
    assert result["correct"], lines
    assert result["metrics"][NAME] == {"value": 1.0, "unit": "share"}


@pytest.mark.parametrize("rows,want", [
    ([(9,), (9,)], None),          # no engine-call tag: a per-shard loop
    ([(1, 1), (1, 1)], None),      # no read past one shard
    ([(9, 1), (1, 1), (9, 9)], 0.5),
    ([(9, 1), (4, 1)], 1.0),
])
def test_the_reader_counts_reads_past_one_shard_by_their_engine_calls(
        rows, want):
    from repro_torch.index.telemetry import Monitor
    mon = Monitor()
    for tags in rows:
        with mon.span("service.route", *tags):
            pass
    assert _reader().read(types.SimpleNamespace(monitor=mon)) == want
    assert _reader().read(types.SimpleNamespace(monitor=None)) is None


def test_the_entry_names_the_service_layer_and_the_inplace_cells():
    per_layer = {m["name"]: m for m in SPEC["per_layer"]}
    m = per_layer[NAME]
    assert (m["unit"], m["better"], m["source"], m["moves"]) == \
        ("share", "higher", "program_span", "keys_per_s")
    assert m["layer"] == per_layer["service.route_ms"]["layer"]
    assert m["workloads"] == ["weblogs-16m-inplace.mix_epoch", PROBE]
    assert SPEC["per_layer"][-1] is m
