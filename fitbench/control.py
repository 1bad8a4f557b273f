"""The control: the reference put in the program's place, one precision
down.  The configurations state float32 keys (integers up to 2^24, exact
there); the control rounds every key and query to bfloat16 and answers with
the plain reference, so the comparison that decides ``correct`` has to
fail it.

    python3 fitbench/control.py --workload <cell> --seeds 1 2 3 --seconds 5

runs the cell once a seed with the control as its service (the benchmark's
own runs never do) and prints each run's checks, one JSON line a seed.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def bf16(x) -> np.ndarray:
    """Round to the nearest bfloat16 (monotone, so a sorted column stays
    sorted)."""
    import torch
    t = torch.as_tensor(np.asarray(x, np.float64))
    return t.to(torch.bfloat16).to(torch.float64).numpy()


class Control:
    """A service with the harness's interface whose every answer is the
    reference's over bfloat16-rounded keys and queries."""

    def __init__(self, config: dict, keys, device: str, monitor):
        from fitbench import reference
        self.reference = reference
        self.base = bf16(keys)
        self.absent = config["guarantees"].get("lookup_absent")
        self.inserts: list[np.ndarray] = []
        self._live = self.base

    def read(self, verb: str, q) -> np.ndarray:
        return self.reference.ranks(self._live, bf16(q), verb, self.absent)

    def insert_many(self, keys) -> None:
        self.inserts.append(bf16(keys))
        hist = self.reference.History(self.base, np.concatenate(self.inserts))
        self._live = hist.live(hist.n_ops)

    def publish(self) -> None:
        """Nothing to maintain."""

    def n_live(self) -> int:
        return int(self._live.size)

    def columns(self) -> list:
        return []

    def warm(self, sizes, verbs, column) -> None:
        """Nothing to build."""

    def close(self) -> None:
        """Nothing to stop."""


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from fitbench import harness
    for seed in args.seeds:
        result, lines = harness.run_cell(ROOT, args.workload, seed,
                                         args.seconds, False,
                                         device=args.device,
                                         service_factory=Control)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": "bfloat16 reference",
                          "correct": result["correct"],
                          "checks": result["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
