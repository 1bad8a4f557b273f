"""The port's Sec. 6 cost model (``repro_torch.core.cost_model``) against the
JAX package's.

The paper's CPU model is copied: every function must return the reference's
value exactly (``==`` on floats).  The device profile is the card's
``GPUCostParams``, built here from the reference ``TPUCostParams``' numbers
(as test input only): under the same numbers the reference's formulas give
the same tier curves, crossings, re-fits and exchange costs.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import cost_model as ref
from repro.core.datasets import weblogs_like
from repro_torch.core import cost_model as cm

P = dict(c_ns=50.0, fanout=16, fill=0.5, buffer_size=16)
CANDS = [16, 32, 64, 128, 256, 512, 1024, 4096, 16384]
SHAPES = [(4, 2), (16, 200), (64, 1000), (1024, 50_000), (16384, 2)]
# the reference profile's field -> the port's
FIELDS = {"hbm_gbps": "hbm_gbps", "dma_setup_ns": "setup_ns",
          "vmem_step_ns": "step_ns", "bytes_per_key": "bytes_per_key",
          "launch_ns": "launch_ns", "plan_ns": "plan_ns"}


def _gpu(tpu):
    return cm.GPUCostParams(**{FIELDS[k]: v
                               for k, v in dataclasses.asdict(tpu).items()})


def _tpu(gpu):
    back = {v: k for k, v in FIELDS.items()}
    return ref.TPUCostParams(**{back[k]: v
                                for k, v in dataclasses.asdict(gpu).items()})


PROFILES = [ref.TPUCostParams(),
            ref.TPUCostParams(hbm_gbps=3350.0, dma_setup_ns=8000.0,
                              vmem_step_ns=0.7, bytes_per_key=4,
                              launch_ns=180_000.0, plan_ns=12_000.0)]


def test_gpu_profile_maps_every_reference_field():
    assert set(FIELDS) == {f.name for f in dataclasses.fields(
        ref.TPUCostParams)}
    assert set(FIELDS.values()) == {f.name for f in dataclasses.fields(
        cm.GPUCostParams)}
    assert dataclasses.asdict(cm.CostParams()) == \
        dataclasses.asdict(ref.CostParams())


@pytest.mark.parametrize("error,segs", SHAPES)
def test_paper_model_equals_the_reference(error, segs):
    for p in (cm.CostParams(**P), cm.CostParams(c_ns=7.5, buffer_size=3)):
        rp = ref.CostParams(**dataclasses.asdict(p))
        assert cm.latency_ns(error, segs, p) == ref.latency_ns(error, segs, rp)
        assert cm.size_bytes(error, segs, p) == ref.size_bytes(error, segs, rp)
        assert cm.range_latency_ns(error, segs, p, 300.0) == \
            ref.range_latency_ns(error, segs, rp, 300.0)


def test_segments_curve_and_choosers_equal_the_reference():
    keys = weblogs_like(100_000)
    fn = cm.learn_segments_fn(keys, CANDS, sample=None)
    rfn = ref.learn_segments_fn(keys, CANDS, sample=None)
    assert [fn(e) for e in range(1, 20_000, 97)] == \
        [rfn(e) for e in range(1, 20_000, 97)]
    sfn = cm.learn_segments_fn(keys, CANDS, sample=20_000)
    rsfn = ref.learn_segments_fn(keys, CANDS, sample=20_000)
    assert [sfn(e) for e in CANDS] == [rsfn(e) for e in CANDS]
    p, rp = cm.CostParams(**P), ref.CostParams(**P)
    for budget in (1.0, 600.0, 900.0, 1200.0):
        assert cm.choose_error_for_latency(budget, fn, CANDS, p) == \
            ref.choose_error_for_latency(budget, rfn, CANDS, rp)
    for budget in (1.0, 4096.0, 64 * 1024.0, 1e6):
        assert cm.choose_error_for_space(budget, fn, CANDS, p) == \
            ref.choose_error_for_space(budget, rfn, CANDS, rp)
    for tpu in PROFILES:
        gpu = _gpu(tpu)
        for budget in (1.0, 10 * tpu.dma_setup_ns, 1e6):
            assert cm.choose_error_for_latency(
                budget, fn, CANDS, p,
                latency_fn=lambda e, s: cm.latency_ns_gpu(e, s, gpu)) == \
                ref.choose_error_for_latency(
                    budget, rfn, CANDS, rp,
                    latency_fn=lambda e, s: ref.latency_ns_tpu(e, s, tpu))


@pytest.mark.parametrize("tpu", PROFILES)
@pytest.mark.parametrize("error,segs", SHAPES)
def test_device_model_curves_and_crossings_equal_the_reference(tpu, error,
                                                                segs):
    gpu = _gpu(tpu)
    cpu, rcpu = cm.CostParams(c_ns=120.0), ref.CostParams(c_ns=120.0)
    assert cm.latency_ns_gpu(error, segs, gpu) == \
        ref.latency_ns_tpu(error, segs, tpu)
    assert cm.range_latency_ns_gpu(error, segs, gpu, 64.0) == \
        ref.range_latency_ns_tpu(error, segs, tpu, 64.0)
    assert cm.scan_ns_per_row_gpu(gpu) == ref.scan_ns_per_row_tpu(tpu)
    for rf, rows in ((0.0, 0.0), (0.3, 256.0)):
        curves = cm.tier_cost_curves(error, segs, cpu, gpu, rf, rows)
        assert curves == ref.tier_cost_curves(error, segs, rcpu, tpu, rf,
                                              rows)
        assert cm.curve_crossings(curves) == ref.curve_crossings(curves)
        assert cm.dispatch_thresholds(error, segs, cpu, gpu, rf, rows) == \
            ref.dispatch_thresholds(error, segs, rcpu, tpu, rf, rows)


@pytest.mark.parametrize("tpu", PROFILES)
def test_exchange_model_equals_the_reference(tpu):
    gpu = _gpu(tpu)
    for batch in (1, 64, 4096, 1 << 20):
        for d in (1, 2, 4, 8):
            for strategy in ("allgather", "a2a"):
                assert cm.exchange_cost_ns(strategy, batch, d, 64, 3000,
                                           gpu) == \
                    ref.exchange_cost_ns(strategy, batch, d, 64, 3000, tpu)
            assert cm.choose_exchange(batch, d, 64, 3000, gpu) == \
                ref.choose_exchange(batch, d, 64, 3000, tpu)
    for d in (1, 4, 8):
        assert cm.exchange_crossover_batch(d, 64, 3000, gpu) == \
            ref.exchange_crossover_batch(d, 64, 3000, tpu)
    with pytest.raises(ValueError, match="unknown exchange"):
        cm.exchange_cost_ns("ring", 8, 2, 64, 3000, gpu)


def _samples(rng, truth, sizes, reps=16, noise=0.02):
    out = {}
    for tier, (fixed, per) in truth.items():
        out[tier] = np.asarray([(b, (fixed + per * b)
                                 * (1 + rng.normal(0, noise)))
                                for b in sizes[tier] for _ in range(reps)])
    return out


@pytest.mark.parametrize("tpu", PROFILES)
def test_fit_and_refit_equal_the_reference(tpu):
    """tests/test_replan.py's synthetic tier samples: the same fit, and the
    same inverse into params, field by field."""
    rng = np.random.default_rng(3)
    truth = {"small": (50.0, 220.0), "medium": (30_000.0, 25.0),
             "large": (110_000.0, 2.0)}
    sizes = {"small": [1, 4, 16, 64], "medium": [128, 512, 2048],
             "large": [4096, 16384, 65536]}
    samples = _samples(rng, truth, sizes)
    curves = cm.fit_tier_curves(samples)
    assert curves == ref.fit_tier_curves(samples)
    few = {"small": samples["small"][:5], "medium": samples["medium"][:1]}
    assert cm.fit_tier_curves(few) == ref.fit_tier_curves(few) == {}
    gpu = _gpu(tpu)
    for part in (curves, {"medium": curves["medium"]},
                 {"large": curves["large"]}, {}):
        cpu2, gpu2 = cm.refit_params(part, 64, 200, cm.CostParams(), gpu)
        rcpu2, tpu2 = ref.refit_params(part, 64, 200, ref.CostParams(), tpu)
        assert dataclasses.asdict(cpu2) == dataclasses.asdict(rcpu2)
        assert _tpu(gpu2) == tpu2


def test_host_calibrate_returns_cost_params():
    keys = np.arange(20_000, dtype=np.float64)
    p = cm.calibrate(keys, batch=256, repeats=2)
    assert isinstance(p, cm.CostParams)
    assert p.c_ns > 0


def test_calibrate_device_inverts_measured_tiers(monkeypatch):
    """On a CPU device the three tiers run there and are timed by host
    wall; the result is the fitted profile (the card's numbers come only
    from a run on the card).  The sweep stops at 4,096 here."""
    monkeypatch.setattr(cm, "CALIBRATE_BATCHES", (1, 8, 64, 512, 4096))
    keys = np.sort(np.random.default_rng(0).integers(0, 2 ** 20, 30_000)
                   ).astype(np.float64)
    cpu, gpu = cm.calibrate_device(keys, device="cpu")
    assert isinstance(cpu, cm.CostParams) and isinstance(gpu,
                                                          cm.GPUCostParams)
    assert cpu.c_ns > 0 and gpu.setup_ns > 0 and gpu.step_ns > 0
    assert gpu.hbm_gbps > 0 and gpu.launch_ns >= 0 and gpu.plan_ns >= 0
    assert gpu.bytes_per_key == 4
    sm, lm = cm.dispatch_thresholds(64, 500, cpu, gpu)
    assert 0 <= sm < lm
