#!/usr/bin/env python3
"""Time ``chip_smoke.py``'s phase 17 (serving on the one-rank (data 1,
model 1) NCCL mesh) of two checkouts in alternating pairs on one CUDA card.

Each run is a process of its own that imports ``chip_smoke.py`` and the
port from one checkout, builds its kernels (``build_all``), opens the
one-rank process group and calls ``serve_mesh``, which checks the tokens
against the steps without a mesh and the launch counts as the smoke does.
Pair ``i`` runs the base checkout first where ``i`` is odd and this one
first where it is even.  Each run appends one JSON line to
``OUT/runs.jsonl``: its label, the card's name and power limit, phase 17's
seconds and, for each model, the mesh's and the no-mesh run's prefill
tokens/s, median decode tick and peak GiB.  Run from the repository root,
with the other checkout unpacked somewhere (``git archive``):

    python3 tools/phase17_pairs.py --base DIR [--pairs 10] \\
        [--out chiprun_out/p17]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def one(tree: Path, label: str, out: Path) -> None:
    """Phase 17 of the checkout at ``tree``, appended to ``out``."""
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import torch
    import torch.distributed as dist
    import chip_smoke
    from repro_torch.index.engine import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import init_ranks
    if not Path(chip_smoke.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"{chip_smoke.__file__} is not under {tree}")
    card = chip_smoke.card_line()
    dev = resolve_device()
    chip_smoke.build_all(_build)
    init_ranks(dev)
    try:
        t0 = time.perf_counter()
        res = chip_smoke.serve_mesh(torch, dev, card)
        res["s"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    with out.open("a") as f:
        f.write(json.dumps({"label": label, "card": card, **res}) + "\n")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", type=Path, help="the other checkout")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "p17")
    ap.add_argument("--one", nargs=2, metavar=("TREE", "LABEL"),
                    help="(internal) one run of the checkout TREE")
    args = ap.parse_args()
    runs = args.out / "runs.jsonl"
    if args.one:
        one(Path(args.one[0]).resolve(), args.one[1], runs)
        return 0
    args.out.mkdir(parents=True, exist_ok=True)
    runs.unlink(missing_ok=True)
    trees = {"base": args.base.resolve(), "this": ROOT}
    for i in range(1, args.pairs + 1):
        for label in ("base", "this") if i % 2 else ("this", "base"):
            with (args.out / f"run{i}_{label}.log").open("w") as log:
                subprocess.run([sys.executable, __file__, "--out",
                                str(args.out), "--one", str(trees[label]),
                                label], check=True, stdout=log,
                               stderr=subprocess.STDOUT)
    for line in runs.read_text().splitlines():
        r = json.loads(line)
        print(r["label"], f"{r['s']:.2f} s", {
            a: round(v["mesh"]["decode_tick_ms"], 1) for a, v in r.items()
            if isinstance(v, dict) and "mesh" in v})
    return 0


if __name__ == "__main__":
    sys.exit(main())
