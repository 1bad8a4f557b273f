"""Each cell end to end on the port's CPU twins, the generators' domain, and
traffic found by name."""
from __future__ import annotations

import json

import numpy as np
import pytest

from conftest import ROOT, SMALL, run_small
from fitbench import harness, loadgen

CELLS = sorted(SMALL)


@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct_on_the_cpu_twins(workload):
    result, lines = run_small(workload)
    assert result["correct"], lines
    assert result["failed"] == 0
    assert result["checks"]["answers_checked"]["value"] > 0
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    want = {m["name"] for m in harness.metrics_of(spec, workload, False)}
    assert set(result["metrics"]) == want
    assert result["device"]["platform"] == "cpu"    # never a device number


@pytest.mark.parametrize("workload", ["iot-16m.probe", "weblogs-16m-lsm.mix"])
def test_traced_run_reads_the_program_counters(workload):
    result, lines = run_small(workload, traced=True)
    assert result["correct"], lines
    got = set(result["metrics"])
    assert "setup.service_s" in got
    if workload == "weblogs-16m-lsm.mix":
        assert {"lsm.read_amp", "lsm.spill_ms"} <= got
    # device numbers come only from the card's trace
    assert "device.idle_share" not in got and "busy_s" not in \
        result["device"]


def _load(workload, seed=99, column=None):
    c = harness.load_cell(ROOT, workload)
    domain = int(c["config"]["keys"]["domain"])
    if column is None:
        column = np.sort(np.random.default_rng(0).integers(
            0, domain, 4096).astype(np.float64))
    mix = c["mix"]
    for group, values in SMALL[workload]["mix"].items():
        mix = {**mix, group: {**(mix.get(group) or {}), **values}}
    load = loadgen.Load(mix, c["config"], column, domain, seed, 0.5)
    load.prepare()
    return load


@pytest.mark.parametrize("workload", CELLS)
def test_generators_stay_in_the_exact_f32_domain(workload):
    load = _load(workload)
    values = [load.column] + [load._resolve(t) for t in load.pool]
    if load.write is not None:
        ins = load.insert_keys(3 * loadgen.INSERT_CHUNK + 5)
        load.acknowledged(ins)
        values += [ins] + [load._resolve(t) for t in load.pool]
    v = np.concatenate(values)
    assert np.all(v == np.floor(v)) and np.abs(v).max() <= 2 ** 24
    assert np.all(v.astype(np.float32).astype(np.float64) == v)


def test_same_seed_same_inputs():
    a, b = _load("weblogs-16m-lsm.mix"), _load("weblogs-16m-lsm.mix")
    # drawn in other pieces, the insert stream is the same
    ia = np.concatenate([a.insert_keys(n) for n in (7, 70000, 3)])
    ib = b.insert_keys(70010)
    np.testing.assert_array_equal(ia, ib)
    for ta, tb in zip(a.pool, b.pool):
        np.testing.assert_array_equal(a._resolve(ta), b._resolve(tb))


def test_latest_reads_follow_ycsb_zipf_over_arrival_order():
    """Every key of a mix call is a record: the newest most often, and
    about as often as Zipf(0.99) gives rank 1."""
    load = _load("weblogs-16m-lsm.mix", column=np.arange(5000.0))
    load.acknowledged(np.full(100, 9999.0))     # the newest records
    q = np.concatenate([load._resolve(t) for t in load.pool])
    n = load.latest.n
    assert n == 5100
    zeta = np.sum(np.arange(1, n + 1, dtype=np.float64) ** -0.99)
    share_newest100 = np.sum(np.arange(1, 101, dtype=np.float64) ** -0.99) \
        / zeta
    got = np.mean(q == 9999.0)
    assert abs(got - share_newest100) < 0.02
    assert np.all(np.isin(q, np.r_[np.arange(5000.0), 9999.0]))


def test_traffic_module_found_by_name(tmp_path):
    (tmp_path / "params_only.json").write_text("{}")
    assert harness.load_class("params_only", tmp_path) is loadgen.Load
    (tmp_path / "own.py").write_text(
        "from fitbench import loadgen\n\n\n"
        "class Load(loadgen.Load):\n    pass\n")
    own = harness.load_class("own", tmp_path)
    assert own is not loadgen.Load and issubclass(own, loadgen.Load)
    with pytest.raises(FileNotFoundError):
        harness.load_class("absent", tmp_path)
