"""The check has to fail: the control (the reference one precision down)
and faults planted under the timed path each make ``correct`` false."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import SMALL, run_small
from fitbench.control import Control


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_the_control_is_not_correct(workload):
    result, _ = run_small(workload, service_factory=Control)
    assert not result["correct"]
    assert result["checks"]["wrong_answers"]["value"] > 0


def _altered(orig):
    def fused(*args, **kw):
        out = orig(*args, **kw).clone()
        out[0] += 1                       # one rank off where it is made
        return out
    return fused


def _half(orig):
    def fused(seg_start, slope, base, seg_end, keys, queries, **kw):
        n = queries.shape[0]
        head = orig(seg_start, slope, base, seg_end, keys,
                    queries[:(n + 1) // 2], **kw)
        return torch.cat([head, torch.zeros(n - head.shape[0],
                                            dtype=head.dtype)])
    return fused


@pytest.mark.parametrize("fault", [_altered, _half])
@pytest.mark.parametrize("workload", ["iot-16m.probe", "weblogs-16m-lsm.mix"])
def test_a_fault_in_the_fused_search_is_caught(monkeypatch, workload, fault):
    import repro_torch.kernels.fitting_lookup as fl
    monkeypatch.setattr(fl, "fitting_search", fault(fl.fitting_search))
    result, _ = run_small(workload)
    assert not result["correct"]


@pytest.mark.parametrize("workload", ["weblogs-16m-lsm.mix",
                                      "weblogs-16m-lsm.ingest"])
def test_writes_that_leave_the_state_unchanged_are_caught(monkeypatch,
                                                          workload):
    from repro_torch.index.lsm import LsmIndexService
    monkeypatch.setattr(LsmIndexService, "insert_many",
                        lambda self, keys, values=None: len(keys))
    result, _ = run_small(workload)
    assert not result["correct"]
