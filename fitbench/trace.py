"""The traced run: ``torch.profiler`` over the measured window, reduced to
what the per-layer metrics read.

The harness marks its own spans with ``record_function``: the window
(``fitbench.window``), each read call (``fitbench.read.<verb>``) and each
write call (``fitbench.write.<op>``).  Device operations (kernels, copies,
fills) are taken from the card's side of the trace, clipped to the window;
a device operation belongs to the read call whose host span holds its start
(a read call waits for its copy back, so its device work lies inside it).
"""
from __future__ import annotations

import contextlib
from collections import defaultdict

import numpy as np

PREFIX = "fitbench."
WINDOW = PREFIX + "window"
READ = PREFIX + "read."
WRITE = PREFIX + "write."
TOP = 10


def span(torch, name: str, enabled: bool):
    """A ``record_function`` range where the run is traced, else nothing."""
    if not enabled:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


def profile(torch, on_card: bool):
    """The profiler over the window: the host's operations and the card's."""
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if on_card:
        acts.append(ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _union(intervals: np.ndarray) -> np.ndarray:
    """Merge (n, 2) intervals into sorted disjoint ones."""
    if not intervals.size:
        return intervals.reshape(0, 2)
    iv = intervals[np.argsort(intervals[:, 0])]
    out = [iv[0].tolist()]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out, np.float64)


def reduce(prof) -> dict | None:
    """The window's device numbers; None where the trace holds no window
    span or no device operation (then nothing device-side can be read)."""
    from torch.autograd import DeviceType
    host, dev = [], []
    for ev in prof.events():
        tr = ev.time_range
        row = (float(tr.start), float(tr.end), ev.name)
        if ev.device_type == DeviceType.CPU:
            host.append(row)
        elif not ev.name.startswith(PREFIX) and \
                not getattr(ev, "is_user_annotation", False):
            dev.append(row)
    windows = [r for r in host if r[2] == WINDOW]
    if not windows or not dev:
        return None
    w0, w1 = windows[0][0], windows[0][1]
    dev = [(max(s, w0), min(e, w1), n) for s, e, n in dev if e > w0 and s < w1]
    if not dev:
        return None
    dev_iv = np.asarray([(s, e) for s, e, _ in dev], np.float64)
    busy = _union(dev_iv)
    busy_us = float((busy[:, 1] - busy[:, 0]).sum())

    by_name: dict[str, float] = defaultdict(float)
    for s, e, n in dev:
        by_name[n] += e - s
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]

    # idle gaps inside the window, labelled by the host spans over them
    edges = np.concatenate([[w0], busy.ravel(), [w1]]).reshape(-1, 2)
    gaps = edges[(edges[:, 1] - edges[:, 0]) > 0]
    gaps = gaps[np.argsort(-(gaps[:, 1] - gaps[:, 0]))][:TOP]
    h = [r for r in host if r[2] != WINDOW]
    hs = np.asarray([r[0] for r in h], np.float64)
    he = np.asarray([r[1] for r in h], np.float64)
    idle_gaps = []
    for s, e in gaps:
        mid = 0.5 * (s + e)
        cover = np.flatnonzero((hs <= mid) & (he >= mid)) if h else []
        idle_gaps.append([_label([h[i] for i in cover]), (e - s) * 1e-6])

    # device work by the read call that launched it
    reads = sorted((r for r in host if r[2].startswith(READ)),
                   key=lambda r: r[0])
    rs = np.asarray([r[0] for r in reads], np.float64)
    re_ = np.asarray([r[1] for r in reads], np.float64)
    in_reads: dict[str, list[float]] = defaultdict(list)
    for s, e, n in dev:
        i = int(np.searchsorted(rs, s, "right")) - 1
        if i >= 0 and s <= re_[i]:
            in_reads[_kind(n)].append(e - s)
    kernels: dict[str, list[float]] = defaultdict(list)
    for s, e, n in dev:
        if _kind(n) == "kernel":
            kernels[n].append(e - s)
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_us * 1e-6,
        "device_ops": [[n, t * 1e-6] for n, t in device_ops],
        "idle_gaps": idle_gaps,
        "read_calls": len(reads),
        "read_memcpy_s": float(np.sum(in_reads.get("memcpy", []))) * 1e-6,
        "kernels": {n: {"count": len(v), "s": float(np.sum(v)) * 1e-6}
                    for n, v in kernels.items()},
    }


def _kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def _label(covering: list) -> str:
    """What the host was doing: the outermost harness span and the innermost
    operation over a gap."""
    if not covering:
        return "host: no span"
    by_len = sorted(covering, key=lambda r: r[1] - r[0])
    inner = by_len[0][2]
    outer = next((r[2] for r in reversed(by_len) if r[2].startswith(PREFIX)),
                 None)
    if outer is None or outer == inner:
        return inner
    return f"{outer} > {inner}"
