"""The in-place write cells (``weblogs-16m-inplace``) on the port's CPU
twins: both cells correct, the traced mix reading its four span metrics,
epoch visibility held by the check, faults caught, and the configuration
held to what the planner resolves for its ``FitSpec``."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from conftest import ROOT, SEED
from fitbench import harness, reference
from fitbench.control import Control

MIX, PROBE = "weblogs-16m-inplace.mix_epoch", "weblogs-16m-inplace.probe"
CONFIG = json.loads((ROOT / "fitbench/configs/weblogs-16m-inplace.json")
                    .read_text())
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NEW_METRICS = {"sharded.insert_us", "sharded.publish_share",
               "sharded.publish_fit_share", "sharded.segment_growth"}
# the full column's plan (nine shards, buffers of 16) over 2^16 keys, with
# a publish after each 512 pending inserts instead of 16,384, so that a
# window of seconds on the CPU publishes several times
SMALL_CONFIG = {
    "keys": {"dataset": "weblogs_like", "n": 2 ** 16, "domain": 2 ** 16},
    "fit_spec": {**CONFIG["fit_spec"], "insert_rate": 512,
                 "n_keys_hint": CONFIG["keys"]["n"]},
    "plan": {**CONFIG["plan"], "publish_every": 512},
}
SMALL = {MIX: {"config": SMALL_CONFIG, "mix": {"read": {"size": 2048}}},
         PROBE: {"config": SMALL_CONFIG, "mix": {"read": {"size": 8192}}}}


def run_small(workload, seconds=1.5, traced=False, service_factory=None):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)       # beside other test workers
    try:
        return harness.run_cell(ROOT, workload, SEED, seconds, traced,
                                device="cpu", overrides=SMALL[workload],
                                service_factory=service_factory)
    finally:
        torch.set_num_threads(threads)


def _service(config, column, monitor=None):
    mod = harness.load_file(harness.HERE / "services" / "inplace_service.py",
                            "fitbench_service_inplace_service")
    return mod.Service(config, column, "cpu", monitor)


@pytest.mark.parametrize("workload", [MIX, PROBE])
def test_cell_runs_correct_on_the_cpu_twins(workload):
    result, lines = run_small(workload)
    assert result["correct"], lines
    assert result["failed"] == 0
    assert result["checks"]["answers_checked"]["value"] > 0
    want = {m["name"] for m in harness.metrics_of(SPEC, workload, False)}
    assert set(result["metrics"]) == want == {"keys_per_s", "setup_s"}
    if workload == MIX:
        assert result["checks"]["live_keys_gap"]["value"] == 0


def test_traced_mix_reads_the_four_span_metrics():
    result, lines = run_small(MIX, seconds=3.0, traced=True)
    assert result["correct"], lines
    got = result["metrics"]
    assert NEW_METRICS <= set(got), sorted(got)
    assert got["sharded.insert_us"]["value"] > 0
    assert 0 < got["sharded.publish_share"]["value"] < 1
    assert 0 < got["sharded.publish_fit_share"]["value"] <= 1
    assert got["sharded.segment_growth"]["value"] >= 1
    # the routed search and the engines' host side read on the CPU too;
    # device numbers come only from the card's trace
    assert got["service.route_ms"]["value"] > 0
    assert got["engine.host_ms"]["value"] > 0
    assert "device.idle_share" not in got and "engine.memcpy_ms" not in got


def test_the_new_metrics_name_their_cell_and_layer():
    per_layer = {m["name"]: m for m in SPEC["per_layer"]}
    for name in NEW_METRICS:
        m = per_layer[name]
        assert m["workloads"] == [MIX] and m["moves"] == "keys_per_s"
        assert m["source"] == "program_span"
    # the probe's routing and engine metrics, and every cell's own
    routed = {"service.route_ms", "engine.host_ms", "engine.memcpy_ms"}
    for cell in (MIX, PROBE):
        assert all(cell in per_layer[n]["workloads"] for n in routed)
    assert harness.metrics_of(SPEC, PROBE, True) == [
        m for m in SPEC["per_layer"]
        if "workloads" not in m or m["name"] in routed]


def test_a_read_between_publishes_misses_the_pending_keys():
    """Inserts short of the count stay unseen, and the mix's reference,
    which takes the count from the configuration, expects exactly that;
    the insert that reaches the count shows them all."""
    c = harness.load_cell(ROOT, MIX)
    config = {**c["config"], **SMALL_CONFIG}
    r = np.random.default_rng(5)
    column = np.sort(r.integers(0, 2 ** 16, 2 ** 16)).astype(np.float64)
    svc = _service(config, column)
    try:
        plan = svc.service.plan
        assert (plan.n_shards, plan.publish_every) == (9, 512)
        load = harness.load_class("mix_epoch")(c["mix"], config, column,
                                               2 ** 16, SEED, 1.0)
        load.prepare()
        new = np.setdiff1d(r.integers(0, 2 ** 16, 4000).astype(np.float64),
                           column)[:600]
        assert new.size == 600
        q = np.concatenate([new, column[::97]])
        for a, b, shown in ((0, 300, 0), (300, 512, 512), (512, 600, 512)):
            svc.insert_many(new[a:b])
            load.acknowledged(new[a:b])
            assert load.visible(b) == shown
            assert svc.service.pending_inserts == b - shown
            hist = load.history()
            for verb in ("lookup", "left"):
                got = np.asarray(svc.read(verb, q))
                want = load.expected(hist.live(shown), q, verb)
                np.testing.assert_array_equal(got, want)
                seen = load.expected(hist.live(b), q, verb)
                assert np.any(got != seen) == (b != shown)
        assert np.all(svc.read("lookup", new[512:]) == -1)
        assert svc.n_live() == hist.live(512).size
    finally:
        svc.close()


def test_a_publish_that_drops_a_shards_buffered_keys_is_caught(monkeypatch):
    from repro_torch.index.sharded import ShardedIndexService
    orig = ShardedIndexService.publish

    def dropping(self, shards=None, force=False):
        for w in self.writers:
            if w.dirty_segments():
                w.buffers = [[] for _ in w.buffers]
                w.buf_payloads = [[] for _ in w.buf_payloads]
                break
        return orig(self, shards, force)

    monkeypatch.setattr(ShardedIndexService, "publish", dropping)
    result, _ = run_small(MIX)
    assert not result["correct"]
    assert result["checks"]["wrong_answers"]["value"] > 0
    assert result["checks"]["live_keys_gap"]["value"] > 0


def test_a_service_that_publishes_at_twice_the_count_is_caught():
    """A later publish than the configuration states is a weaker
    visibility, not a faster run: every read past an odd multiple of the
    count misses the keys its reference shows."""
    mod = harness.load_file(harness.HERE / "services" / "inplace_service.py",
                            "fitbench_service_inplace_service")

    def late(config, column, device, monitor):
        svc = mod.Service(config, column, device, monitor)
        svc.service.publish_every *= 2
        return svc

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        small = {"config": SMALL_CONFIG,
                 "mix": {"read": {"size": 2048}, "check": {"sample": 0}}}
        result, _ = harness.run_cell(ROOT, MIX, SEED, 1.5, False,
                                     device="cpu", overrides=small,
                                     service_factory=late)
    finally:
        torch.set_num_threads(threads)
    assert not result["correct"]
    assert result["checks"]["wrong_answers"]["value"] > 0


@pytest.mark.parametrize("workload", [MIX, PROBE])
def test_the_control_is_not_correct(workload):
    result, _ = run_small(workload, service_factory=Control)
    assert not result["correct"]
    assert result["checks"]["wrong_answers"]["value"] > 0


def test_a_service_without_a_batch_insert_fails_at_the_first_insert(
        monkeypatch):
    """What the parent commit does in the mix: raise, not hang."""
    from repro_torch.index.sharded import ShardedIndexService
    monkeypatch.delattr(ShardedIndexService, "insert_many")
    with pytest.raises(AttributeError, match="insert_many"):
        run_small(MIX)


def test_the_configuration_is_what_the_planner_resolves():
    """The file's plan is ``fit.plan``'s for the file's ``FitSpec`` at the
    column's size (a 2^16-key sample of the same shape, scaled up by
    ``n_keys_hint``), and ``open_index`` builds that service."""
    from repro_torch.index.fit import FitSpec, plan
    from repro_torch.index.sharded import ShardedIndexService
    from fitbench import keys as K
    from fitbench.datasets import weblogs_like
    n = CONFIG["keys"]["n"]
    sample = K.integer_column(torch, weblogs_like.generate(
        torch, 2 ** 16, SEED, "cpu"), CONFIG["keys"]["domain"])
    fs = {k: tuple(v) if isinstance(v, list) else v
          for k, v in CONFIG["fit_spec"].items()}
    p = plan(sample, FitSpec(**fs, n_keys_hint=n), assume_sorted=True)
    want = CONFIG["plan"]
    assert (p.write_mode, p.n_shards, p.buffer_size, p.publish_every,
            p.backend, p.error - p.buffer_size) == (
        want["write_mode"], want["n_shards"], want["buffer_size"],
        want["publish_every"], want["backend"], want["err_seg"])
    assert p.error == CONFIG["error"] == fs["error"]
    import inspect
    default = inspect.signature(ShardedIndexService).parameters[
        "auto_rebalance"].default
    assert want["auto_rebalance"] is default is False
    svc = _service({**CONFIG, **SMALL_CONFIG}, sample)
    try:
        assert isinstance(svc.service, ShardedIndexService)
        assert svc.service.n_shards == want["n_shards"]
        assert svc.service.buffer_size == want["buffer_size"]
        assert svc.service.default_backend == want["backend"]
        assert svc.pipe.flush_threshold == svc.service.plan.flush_threshold
        assert svc.pipe.max_wait_us == svc.service.plan.max_wait_us
        assert svc.pipe._maintenance is None        # no cadence thread
    finally:
        svc.close()
