"""CPU tests of the benchmark: run with

    python -m pytest fitbench/tests

Cells run here at small sizes on the port's plain torch twins (the engines
placed on the CPU); tests that need the card are marked ``gpu`` and skip
inside the test where there is none."""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

IOT = {"keys": {"dataset": "iot_like", "n": 2 ** 19, "domain": 2 ** 19}}
WEBLOGS = {"keys": {"dataset": "weblogs_like", "n": 2 ** 15,
                    "domain": 2 ** 15}, "memtable_capacity": 1024}

# each cell at a size a CPU test holds: the iot column keeps enough
# segments (about 400) for the cost model's dispatch tiers to meet
SMALL = {
    "iot-16m.probe": {"config": IOT, "mix": {"read": {"size": 8192}}},
    "weblogs-16m-lsm.mix": {"config": WEBLOGS,
                            "mix": {"read": {"size": 2048}}},
    "weblogs-16m-lsm.ingest": {"config": WEBLOGS,
                               "mix": {"write": {"batch": 1024,
                                                 "publish_every": 1024}}},
}
SEED = 2 ** 31 + 12345


def run_small(workload: str, seconds: float = 1.0, traced: bool = False,
              seed: int = SEED, service_factory=None):
    from fitbench import harness
    return harness.run_cell(ROOT, workload, seed, seconds, traced,
                            device="cpu", overrides=SMALL[workload],
                            service_factory=service_factory)
