"""The benchmark of the PyTorch and CUDA port of FITing-Tree.

    python3 fitbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the CUDA card this process sees and
prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``; the numbers compared with the reference come last, under
``checks``, and again as the last lines of standard error.  Exits non-zero,
printing no result, without a card, or if JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".fitbench_cache"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # every build and kernel cache inside the checkout, at fixed paths
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    from fitbench import harness
    cell = harness.load_cell(ROOT, args.workload)["cell"]
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"fitbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); this process sees {seen}", file=sys.stderr)
        return 3
    result, lines = harness.run_cell(ROOT, args.workload, args.seed,
                                     args.seconds, bool(args.trace),
                                     t_process=T_PROCESS)
    if result["foreign_modules"]:
        for line in lines:
            print(line, file=sys.stderr)
        print("fitbench: JAX or the JAX package is loaded in this process: "
              f"{result['foreign_modules']}; no result", file=sys.stderr)
        return 4
    del result["foreign_modules"]
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
