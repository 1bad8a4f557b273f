"""One run of one cell: set-up, the measured window, the check, the metrics.

Everything a cell is made of is found by name: its configuration in the
file ``BENCHMARK.json`` names, the key shape in ``fitbench/datasets/``, the
service in ``fitbench/services/``, the mix in ``fitbench/traffic/``
(``<mix>.json``, its parameters, and ``<mix>.py`` where the mix brings
its own ``Load``; see ``fitbench/loadgen.py``) and each metric's reader in
``fitbench/metrics/<metric>.py`` (a function ``read(run)`` that returns a
number, or None where it finds nothing to read).  A new cell, mix or metric
is new files and new entries.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np

from fitbench import keys as K
from fitbench import loadgen, roofline, trace

HERE = Path(__file__).resolve().parent
TRAFFIC = HERE / "traffic"
FOREIGN = ("jax", "jaxlib", "flax", "repro")     # top-level names, whole


def load_file(path: Path, name: str) -> types.ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(root: Path, workload: str) -> dict:
    """The cell's entries: ``spec`` (BENCHMARK.json), ``cell``, ``config``
    (the file's contents), ``mix`` (its parameters)."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"cells: {sorted(cells)}")
    cell = cells[workload]
    entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = json.loads((root / entry["file"]).read_text())
    params = TRAFFIC / f"{cell['traffic']}.json"
    mix = json.loads(params.read_text()) if params.is_file() else {}
    return {"spec": spec, "cell": cell, "config": config, "mix": mix}


def load_class(name: str, directory: Path = TRAFFIC) -> type:
    """The mix's ``Load``: its own module's where ``<name>.py`` exists,
    else the general generator's."""
    path = directory / f"{name}.py"
    if path.is_file():
        return load_file(path, f"fitbench_traffic_{name}").Load
    if not (directory / f"{name}.json").is_file():
        raise FileNotFoundError(f"no traffic {name!r} in {directory}")
    return loadgen.Load


def metrics_of(spec: dict, workload: str, traced: bool) -> list[dict]:
    """The metrics a run of ``workload`` reports: its end-to-end ones, or
    with the trace its per-layer ones."""
    group = spec["per_layer"] if traced else spec["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def foreign_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FOREIGN))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not read"


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             traced: bool, *, device: str = "cuda", t_process: float | None
             = None, service_factory=None, overrides: dict | None = None
             ) -> tuple[dict, list[str]]:
    """One run.  Returns the result line's object and the lines of the
    check for standard error.  ``service_factory`` puts another service in
    the program's place (the control); ``overrides`` change keys of the
    configuration (``"config"``) and of the mix's groups (``"mix"``): the
    CPU tests' small sizes."""
    import torch
    t_process = time.perf_counter() if t_process is None else t_process
    c = load_cell(root, workload)
    spec, config, mix = c["spec"], c["config"], c["mix"]
    overrides = overrides or {}
    config = {**config, **overrides.get("config", {})}
    for group, values in overrides.get("mix", {}).items():
        mix = {**mix, group: {**(mix.get(group) or {}), **values}}
    on_card = device == "cuda"
    parts = {"start_s": time.perf_counter() - t_process}

    # ---------------------------------------------------------- set-up
    t = time.perf_counter()
    kc = config["keys"]
    dataset = load_file(HERE / "datasets" / f"{kc['dataset']}.py",
                        f"fitbench_dataset_{kc['dataset']}")
    times = dataset.generate(torch, int(kc["n"]), seed, device)
    column = K.integer_column(torch, times, int(kc["domain"]))
    del times
    parts["data_s"] = time.perf_counter() - t

    monitor = None
    if traced:
        from repro_torch.index.telemetry import Monitor
        monitor = Monitor(capacity=2 ** 20)
        monitor.enabled = False          # set-up records nothing
    t = time.perf_counter()
    if service_factory is None:
        svc_mod = load_file(HERE / "services" / f"{config['service']}.py",
                            f"fitbench_service_{config['service']}")
        service_factory = svc_mod.Service
    service = service_factory(config, column, device, monitor)
    parts["service_s"] = time.perf_counter() - t

    t = time.perf_counter()
    load = load_class(c["cell"]["traffic"])(mix, config, column,
                                            int(kc["domain"]), seed, seconds)
    load.prepare()
    parts["requests_s"] = time.perf_counter() - t

    t = time.perf_counter()
    service.warm(load.warm_sizes(), load.verbs, column)
    if on_card:
        torch.cuda.synchronize()
    parts["warm_s"] = time.perf_counter() - t
    gc.collect()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_process

    # ---------------------------------------------------------- window
    if monitor is not None:
        monitor.enabled = True
    prof = trace.profile(torch, on_card) if traced else None
    if prof is not None:
        with prof:
            out = load.run(torch, service, True)
            if on_card:
                torch.cuda.synchronize()
    else:
        out = load.run(torch, service, False)
    if monitor is not None:
        monitor.enabled = False
    peak = int(torch.cuda.max_memory_allocated()) if on_card else 0

    # -------------------------------------------- after the window closed
    readback = load.read_back(service)
    service.close()
    summary = trace.reduce(prof) if prof is not None and on_card else None
    kernel = _kernel_work(torch, out, config, device, summary) \
        if traced and on_card else None
    del service
    gc.collect()

    checks = _check(load, out, readback)
    correct = all(ok for _, _, _, ok in checks.values())
    found = foreign_modules()

    run = types.SimpleNamespace(
        outcome=out, setup_s=setup_s, setup_parts=parts, trace=summary,
        monitor=monitor, kernel=kernel, config=config,
        mix=mix, card=torch.cuda.get_device_name() if on_card else "cpu")
    metrics = {}
    for m in metrics_of(spec, workload, traced):
        reader = load_file(HERE / "metrics" / f"{m['name']}.py",
                           f"fitbench_metric_{m['name']}")
        value = reader.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": run.card, "count": 1 if on_card else 0,
           "memory_peak_bytes": peak}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
    result = {"correct": bool(correct and not found),
              "attempted": int(out.attempted), "failed": int(out.failed),
              "metrics": metrics, "device": dev}
    if summary is not None:
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["setup_parts"] = parts
    result["window_s"] = out.window_s
    result["card"] = card_line() if on_card else "cpu"
    result["checks"] = {k: {"value": v, "limit": lim, "op": op}
                        for k, (v, lim, op, _) in checks.items()}
    lines = [f"check {k}: {v} {op} {lim} ({'ok' if ok else 'FAILED'})"
             for k, (v, lim, op, ok) in checks.items()]
    lines += [f"error: {e}" for e in out.errors[:5]]
    if found:
        lines.append(f"loaded after the window: {', '.join(found)}")
    result["foreign_modules"] = found
    return result, lines


def _kernel_work(torch, out, config, device, summary) -> dict | None:
    """The bytes of every fused-search launch the traced window's reads
    made, beside the profiler's time of those launches."""
    if summary is None or not out.kernel_calls:
        return None
    error = int(config["error"])
    memo, cols = {}, {}
    total, launches = 0, 0
    for columns, q in out.kernel_calls:
        for keys, n_seg in columns:
            k = (id(keys), id(q))
            if k not in memo:
                if id(keys) not in cols:
                    cols[id(keys)] = torch.tensor(np.array(keys),
                                                  device=device)
                memo[k] = roofline.search_bytes(cols[id(keys)], q, error,
                                                n_seg, device)
            total += memo[k]
            launches += 1
    named = [v for n, v in summary["kernels"].items()
             if "fitting_search" in n]
    return {"bytes": total, "launches": launches,
            "events": sum(v["count"] for v in named),
            "kernel_s": sum(v["s"] for v in named)}


def _answer(got, n: int) -> np.ndarray:
    """An answer as n int64 ranks; one of another length is wrong in every
    place (-2 is no rank)."""
    got = np.asarray(got).ravel()
    if got.size != n:
        return np.full(n, -2, np.int64)
    return got.astype(np.int64)


def _check(load, out, readback) -> dict:
    """Every answer checked against the reference: (value, limit, op, ok)
    for each number compared."""
    hist = load.history()
    wrong = compared = 0
    groups: dict[int, dict[str, list]] = {}
    for o in out.observed:
        groups.setdefault(o.w, {}).setdefault(o.verb, []).append(o)
    for w, by_verb in groups.items():
        live = hist.live(w)
        for verb, obs in by_verb.items():
            q = np.concatenate([o.queries for o in obs])
            got = np.concatenate([_answer(o.answer, o.queries.size)
                                  for o in obs])
            want = load.expected(live, q, verb)
            wrong += int(np.count_nonzero(got != want))
            compared += int(q.size)
    checks = {}
    if readback is not None:
        live = hist.live(hist.n_ops)
        q = readback["queries"]
        for verb, got in readback["answers"].items():
            want = load.expected(live, q, verb)
            wrong += int(np.count_nonzero(_answer(got, q.size) != want))
            compared += int(want.size)
        gap = abs(int(readback["n_live"]) - int(live.size))
        checks["live_keys_gap"] = (gap, 0, "<=", gap <= 0)
    checks = {"wrong_answers": (wrong, 0, "<=", wrong <= 0),
              "unanswered": (out.unanswered, 0, "<=", out.unanswered <= 0),
              **checks,
              "answers_checked": (compared, 1, ">=", compared >= 1)}
    return checks
