"""The port's planner (``repro_torch.index.fit``) against the JAX package's.

On the specs of ``tests/test_fit.py`` both planners must resolve the same
plan, field by field and to tolerance 0: the port's backend names map to the
reference's (``cuda`` = ``pallas``, ``torch-bisect`` = ``xla-bisect``) and its
device profile is given the reference TPU profile's numbers (as test input;
``hardware="gpu"`` stands for ``"tpu"``).  The port's ``open_index`` builds
its own services (on the CPU here; an lsm plan its ``LsmIndexService``, a
device plan its ``DeviceShardedService``), and the reference's JSON loads.
"""
import dataclasses
import json

import numpy as np
import pytest

from repro.core.cost_model import TPUCostParams
from repro.core.datasets import lognormal_keys, uniform_keys
from repro.index import fit as ref
from repro_torch.core.cost_model import GPUCostParams
from repro_torch.index import LsmIndexService, fit
from repro_torch.serve import (DeviceShardedService, IndexService,
                               ShardedIndexService)

CANDS = (8, 32, 128, 512, 2048)
BACKENDS = {"cuda": "pallas", "torch-bisect": "xla-bisect"}
CPU = {"device": "cpu"}
ON_CPU = {"cuda": CPU, "torch-bisect": CPU, "torch-window": CPU,
          "dispatch": CPU}


def _gpu(tpu):
    return GPUCostParams(hbm_gbps=tpu.hbm_gbps, setup_ns=tpu.dma_setup_ns,
                         step_ns=tpu.vmem_step_ns,
                         bytes_per_key=tpu.bytes_per_key,
                         launch_ns=tpu.launch_ns, plan_ns=tpu.plan_ns)


def _duplicate_heavy(n=20_000, seed=5):
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(np.arange(n // 8, dtype=np.float64), size=n))


DATASETS = {
    "uniform": lambda: uniform_keys(20_000, seed=3),
    "lognormal": lambda: lognormal_keys(20_000, seed=4),
    "duplicate_heavy": _duplicate_heavy,
}


def _specs(tpu=None, **kw):
    """The same spec in both packages (device profile numbers shared)."""
    tpu = tpu or TPUCostParams()
    hw = kw.pop("hardware", "cpu")
    ours = fit.FitSpec(**kw, hardware="gpu" if hw == "tpu" else hw,
                       gpu_params=_gpu(tpu))
    return ours, ref.FitSpec(**kw, hardware=hw, tpu_params=tpu)


def _assert_same_plan(ours, theirs):
    got, want = dataclasses.asdict(ours), dataclasses.asdict(theirs)
    got.pop("spec"), want.pop("spec")
    backend = got.pop("backend")
    assert BACKENDS.get(backend, backend) == want.pop("backend")
    hardware = got.pop("hardware")
    assert {"gpu": "tpu"}.get(hardware, hardware) == want.pop("hardware")
    assert got == want


def _hinted(keys):
    probe = ref.plan(keys, ref.FitSpec(error=64, candidate_errors=CANDS))
    lats = [c.latency_ns for c in probe.candidates]
    sizes = [c.size_bytes for c in probe.candidates]
    return [
        dict(error=64, candidate_errors=CANDS),
        dict(latency_budget_ns=(min(lats) + max(lats)) / 2,
             candidate_errors=CANDS),
        dict(latency_budget_ns=max(lats), candidate_errors=CANDS),
        dict(storage_budget_bytes=(min(sizes) + max(sizes)) / 2,
             candidate_errors=CANDS),
        dict(latency_budget_ns=900.0, candidate_errors=CANDS,
             batch_sizes=(1, 2, 4)),
        dict(latency_budget_ns=900.0, candidate_errors=CANDS,
             batch_sizes=(1 << 20,)),
        dict(error=64, candidate_errors=CANDS, insert_rate=200_000.0,
             duplicate_density=0.5),
        dict(error=64, candidate_errors=CANDS, range_fraction=0.4,
             range_scan_rows=512),
        dict(error=1, candidate_errors=CANDS, insert_rate=1000.0),
        dict(error=64, candidate_errors=CANDS, device_count=4,
             batch_sizes=(64, 1 << 16)),
        dict(error=64, hardware="tpu", candidate_errors=CANDS),
        dict(latency_budget_ns=2000.0, hardware="tpu", candidate_errors=CANDS,
             range_fraction=0.2),
    ]


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_plan_equals_the_reference_field_by_field(name):
    keys = DATASETS[name]()
    profiles = (TPUCostParams(), TPUCostParams(launch_ns=1200.0,
                                               plan_ns=300.0))
    for i, kw in enumerate(_hinted(keys)):
        ours, theirs = _specs(profiles[i % 2], **kw)
        _assert_same_plan(fit.plan(keys, ours), ref.plan(keys, theirs))
        if "error" not in kw:
            assert fit.brute_force_choice(keys, ours) == \
                ref.brute_force_choice(keys, theirs)


def test_plan_from_a_key_sample_equals_the_reference():
    keys = uniform_keys(20_000, seed=9)
    ours, theirs = _specs(latency_budget_ns=800.0,
                          key_sample=tuple(keys[::20]),
                          n_keys_hint=keys.shape[0], candidate_errors=CANDS)
    _assert_same_plan(fit.plan(None, ours), ref.plan(None, theirs))
    assert [fit.planned_buffer(e) for e in range(1, 300)] == \
        [ref.planned_buffer(e) for e in range(1, 300)]


@pytest.mark.parametrize("kw", [
    dict(latency_budget_ns=1e-3, candidate_errors=CANDS),
    dict(storage_budget_bytes=1.0, candidate_errors=CANDS),
    dict(latency_budget_ns=1.0, candidate_errors=CANDS, hardware="tpu"),
    dict(latency_budget_ns=10.0, candidate_errors=CANDS, range_fraction=0.9,
         range_scan_rows=4096),
])
def test_infeasible_spec_names_the_same_tightest_budget(kw):
    keys = uniform_keys(20_000, seed=8)
    ours, theirs = _specs(**kw)
    with pytest.raises(fit.InfeasibleSpecError) as got:
        fit.plan(keys, ours)
    with pytest.raises(ref.InfeasibleSpecError) as want:
        ref.plan(keys, theirs)
    assert (got.value.objective, got.value.budget, got.value.tightest) == \
        (want.value.objective, want.value.budget, want.value.tightest)
    assert str(got.value) == str(want.value)


def test_open_index_builds_the_ported_services():
    rng = np.random.default_rng(12)
    keys = np.sort(rng.choice(2 ** 22, size=20_000,
                              replace=False)).astype(np.float64)
    fresh = np.setdiff1d(rng.choice(2 ** 22, size=256, replace=False)
                         .astype(np.float64), keys)[:64]
    one = fit.open_index(keys, fit.FitSpec(error=64, candidate_errors=CANDS,
                                           batch_sizes=(1 << 20,),
                                           gpu_params=_gpu(TPUCostParams())),
                         engine_opts=ON_CPU)
    assert isinstance(one, IndexService) and one.default_backend == "cuda"
    many = fit.open_index(keys, fit.FitSpec(error=64, candidate_errors=CANDS,
                                            insert_rate=200_000.0),
                          engine_opts=ON_CPU, skew_threshold=3.0)
    assert isinstance(many, ShardedIndexService)
    assert many.n_shards == 4 and many.skew_threshold == 3.0
    assert many.default_backend == "dispatch"
    for svc in (one, many):
        np.testing.assert_array_equal(svc.lookup(keys[::97]),
                                      np.arange(0, keys.shape[0], 97))
        for k in fresh:
            svc.insert(float(k))
        svc.publish()
        union = np.sort(np.concatenate([keys, fresh]))
        np.testing.assert_array_equal(svc.lookup(fresh),
                                      np.searchsorted(union, fresh))
    with pytest.raises(TypeError, match="FitSpec or IndexPlan"):
        fit.open_index(keys, {"error": 64})


def test_lsm_and_device_plans_open_the_ports_services():
    """An lsm plan opens the port's ``LsmIndexService``, equal to the
    reference's on the same plan (its manifest and every write's answers),
    and a device plan the port's ``DeviceShardedService`` on the rows
    ``devices`` names, whose ``search`` equals the reference's on that plan
    (held to one row there: this process has one JAX device; the D = 8 case
    is in ``tests/test_torch_device_plane.py``)."""
    rng = np.random.default_rng(13)
    keys = np.sort(rng.choice(2 ** 22, size=5_000,
                              replace=False)).astype(np.float64)
    spec = dict(error=64, write_heavy=True, candidate_errors=CANDS,
                insert_rate=6_000.0)
    lsm = fit.plan(keys, fit.FitSpec(**spec))
    ref_lsm = ref.plan(keys, ref.FitSpec(**spec))
    assert lsm.write_mode == ref_lsm.write_mode == "lsm"
    ours = fit.open_index(keys, lsm, engine_opts=ON_CPU)
    theirs = ref.open_index(keys, ref_lsm)
    assert isinstance(ours, LsmIndexService) and ours.plan is lsm
    assert (ours.memtable_capacity, ours.level_fanout, ours.error) == \
        (theirs.memtable_capacity, theirs.level_fanout, theirs.error) == \
        (1500, 4, 64)
    assert ours.default_backend == theirs.default_backend == "dispatch"
    new = np.floor(rng.uniform(0, keys[-1], 4 * 1500 + 7))
    for svc in (ours, theirs):
        svc.insert_many(new)
        svc.delete(float(new[3]))
        svc.publish()
    assert ours.level_set.runs_per_level() == \
        theirs.level_set.runs_per_level()
    live = np.sort(np.concatenate([keys, new[new != new[3]]]))
    q = np.concatenate([keys[::53], new[::11], [-1.0, keys[-1] + 1]])
    for side in ("left", "right"):
        np.testing.assert_array_equal(ours.search(q, side),
                                      theirs.search(q, side))
        np.testing.assert_array_equal(ours.search(q, side),
                                      np.searchsorted(live, q, side))
    dev_spec = dict(error=64, device_count=2, candidate_errors=CANDS)
    dev = fit.plan(keys, fit.FitSpec(**dev_spec))
    ref_dev = ref.plan(keys, ref.FitSpec(**dev_spec))
    assert dev.backend == ref_dev.backend == "device"
    assert (dev.device_count, dev.exchange) == (ref_dev.device_count,
                                                ref_dev.exchange)
    ours = fit.open_index(keys, dev, devices=["cpu"] * 2)
    theirs = ref.open_index(keys, dataclasses.replace(
        ref_dev, device_count=1, n_shards=1))
    assert isinstance(ours, DeviceShardedService) and ours.plan is dev
    assert ours.n_devices == 2 and ours.exchange == dev.exchange
    for side in ("left", "right"):
        np.testing.assert_array_equal(ours.search(q, side),
                                      theirs.search(q, side))
        np.testing.assert_array_equal(ours.search(q, side),
                                      np.searchsorted(keys, q, side))


def test_raw_knob_plans_default_to_the_card():
    p = fit.IndexPlan.from_knobs(16, n_shards=2, buffer_size=4)
    assert p.backend == "cuda" and p.small_max is None
    assert fit.IndexPlan(error=8).backend == "cuda"
    with pytest.raises(ValueError, match="'tpu'.*does not carry over"):
        fit.FitSpec(error=64, hardware="tpu")
    with pytest.raises(ValueError, match="hardware must be"):
        fit.FitSpec(error=64, hardware="fpga")


def test_reference_json_loads_with_names_mapped():
    keys = uniform_keys(20_000, seed=16)
    spec = ref.FitSpec(latency_budget_ns=900.0, batch_sizes=[1 << 20],
                       candidate_errors=CANDS, insert_rate=10.0)
    got = fit.FitSpec.from_json(spec.to_json())
    want = fit.FitSpec(latency_budget_ns=900.0, batch_sizes=(1 << 20,),
                       candidate_errors=CANDS, insert_rate=10.0)
    assert got == want
    with pytest.raises(ValueError, match="'tpu'"):
        fit.FitSpec.from_json(ref.FitSpec(error=64, hardware="tpu").to_json())
    with pytest.raises(ValueError, match="unknown FitSpec fields"):
        fit.FitSpec.from_json(json.dumps({"error": 64, "bogus": 1}))

    theirs = ref.plan(keys, spec)
    assert theirs.backend == "pallas"
    plan = fit.IndexPlan.from_json(json.dumps(dataclasses.asdict(theirs)))
    assert plan.backend == "cuda" and plan.spec == want
    _assert_same_plan(plan, theirs)
    assert fit.IndexPlan.from_json(plan.to_json()) == plan
    ours = fit.plan(keys, fit.FitSpec(error=64, candidate_errors=CANDS,
                                      hardware="gpu"))
    assert fit.IndexPlan.from_json(ours.to_json()) == ours


def test_explain_names_the_ported_tiers():
    keys = uniform_keys(20_000, seed=7)
    p = fit.plan(keys, fit.FitSpec(latency_budget_ns=900.0,
                                   candidate_errors=CANDS, hardware="gpu",
                                   gpu_params=_gpu(TPUCostParams())))
    report = p.explain()
    assert "hardware=gpu" in report and "chosen" in report
    assert f"numpy <= {p.small_max} < torch-bisect < {p.large_min} <= cuda" \
        in report
