"""Collective bytes and counts of one step (port of
``repro.launch.hlo_analysis``).

Two accountants fill the same keys: ``<collective>_bytes`` and
``<collective>_count`` for the five collective kinds,
``total_collective_bytes``, ``total_collective_bytes_raw`` and
``wire_bytes``.

* :func:`analyze_collectives` is the reference's, copied unchanged with its
  helpers: it reads post-SPMD HLO text.  GSPMD places per-layer collectives
  (FSDP all-gathers, TP reduce-scatters) inside the scan's while body; a
  flat text scan counts them once.  The parser builds the computation call
  graph (while body/condition, calls, fusions), extracts each while's trip
  count from its condition's comparison constant, and multiplies collective
  bytes by the product of enclosing trip counts.  Heuristic, text-based,
  validated against known scan structures in tests.
* :func:`trace_collectives` is the port's: it runs one step under a
  ``TorchDispatchMode`` and counts each collective op the step issues
  (``_c10d_functional``, which DTensor's redistributions issue, and the
  ``c10d`` ops behind ``torch.distributed``'s calls), its bytes the bytes
  of the tensors it returns (the gathered, the scattered or the reduced
  result, as the HLO's result shape).  The port runs its layers in a
  Python loop, so every collective of every layer is seen once as it runs:
  no trip count is needed, and the raw total equals the total.

The two differ by design.  GSPMD plans its own collectives over the whole
program; the port's are the ones its code issues: a gather over the data
axes of each layer's parameters (``act_ctx.materialize``; the attention and
MLP weights keep their ``model`` shard), again under remat, the two sums
over ``model`` a layer of the tensor-parallel attention and MLP
(``models/tensor_parallel.py``; in the backward, the sums of the gradients
that enter them), at decode over a ring split by length the gather of the
q heads and the log-sum-exp combine, a reduce-scatter of each gradient
back into its placement, the reductions of ``placed_like`` and of the
optimizer's norm.  So the port's numbers are not held to the reference's.

This module is host code: the dispatch mode is built when a step is
traced, and nothing here imports torch at module scope.
"""
from __future__ import annotations

import re
from collections import defaultdict

_DTYPE_BYTES = {"pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2,
                "f16": 2, "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8,
                "f64": 8, "c64": 8, "c128": 16}

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

_SHAPE_RE = re.compile(r"(pred|[sufc]\d+|bf16)\[([0-9,]*)\]")
_COMP_START = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*\(.*->.*\{\s*$")
_COLL_RE = re.compile(
    r"= (.*?) (all-reduce|all-gather|reduce-scatter|all-to-all|"
    r"collective-permute)(-start)?\(")
_REF_RE = re.compile(r"(?:condition|body|to_apply|calls)=%?([\w.\-]+)")
_WHILE_RE = re.compile(r"= .*? while\(.*?\), condition=%?([\w.\-]+), "
                       r"body=%?([\w.\-]+)")
_CONST_RE = re.compile(r"constant\((\d+)\)")


def shape_bytes(text: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(text):
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES.get(dt, 4)
    return total


def split_computations(hlo: str) -> dict[str, list[str]]:
    """computation name -> its body lines."""
    comps: dict[str, list[str]] = {}
    cur = None
    for raw in hlo.splitlines():
        line = raw.rstrip()
        if cur is None:
            m = _COMP_START.match(line.strip())
            if m and line.rstrip().endswith("{"):
                cur = m.group(1)
                comps[cur] = []
        else:
            if line.strip() == "}":
                cur = None
            else:
                comps[cur].append(line)
    return comps


def _entry_name(hlo: str, comps: dict[str, list[str]]) -> str | None:
    m = re.search(r"^ENTRY\s+%?([\w.\-]+)", hlo, re.M)
    if m and m.group(1) in comps:
        return m.group(1)
    return next(iter(comps), None)


def analyze_collectives(hlo: str) -> dict:
    """Per-type collective bytes/counts, loop-multiplied; plus raw (x1) sums."""
    comps = split_computations(hlo)
    entry = _entry_name(hlo, comps)

    # per-computation local collective sums + call edges
    local = {}
    edges = defaultdict(list)      # comp -> [(child, multiplier)]
    for name, lines in comps.items():
        loc = defaultdict(int)
        cnt = defaultdict(int)
        for ln in lines:
            cm = _COLL_RE.search(ln)
            if cm:
                b = shape_bytes(cm.group(1))
                # CPU-backend artifact: bf16 all-reduces are *promoted* to f32
                # (reducer named ...._promoted); a TPU reduces natively in
                # bf16, so count promoted ARs at half width.
                if cm.group(2) == "all-reduce" and "_promoted" in ln \
                        and "f32[" in cm.group(1):
                    b //= 2
                loc[cm.group(2)] += b
                cnt[cm.group(2)] += 1
            wm = _WHILE_RE.search(ln)
            if wm:
                cond, body = wm.group(1), wm.group(2)
                trip = _trip_count(comps.get(cond, []))
                edges[name].append((body, trip))
                edges[name].append((cond, trip))
            else:
                for ref in _REF_RE.findall(ln):
                    if ref in comps:
                        edges[name].append((ref, 1))
        local[name] = (dict(loc), dict(cnt))

    # multiplier of each computation = sum over call paths of trip products
    mult = defaultdict(float)
    if entry is not None:
        stack = [(entry, 1.0, 0)]
        while stack:
            node, m, depth = stack.pop()
            mult[node] += m
            if depth > 12:
                continue
            for child, f in edges.get(node, []):
                stack.append((child, m * f, depth + 1))

    out = {f"{c}_bytes": 0 for c in COLLECTIVES}
    out.update({f"{c}_count": 0 for c in COLLECTIVES})
    raw = {f"{c}_bytes": 0 for c in COLLECTIVES}
    for name, (loc, cnt) in local.items():
        for c in COLLECTIVES:
            if c in loc:
                out[f"{c}_bytes"] += int(loc[c] * max(mult.get(name, 1.0), 1.0))
                out[f"{c}_count"] += int(cnt[c] * max(mult.get(name, 1.0), 1.0))
                raw[f"{c}_bytes"] += loc[c]
    out["total_collective_bytes"] = sum(out[f"{c}_bytes"] for c in COLLECTIVES)
    out["total_collective_bytes_raw"] = sum(raw[f"{c}_bytes"]
                                            for c in COLLECTIVES)
    # ring-collective wire bytes per device: all-reduce moves ~2x its result
    # size (reduce-scatter + all-gather phases); the others move ~1x
    out["wire_bytes"] = (2 * out["all-reduce_bytes"]
                         + out["all-gather_bytes"]
                         + out["reduce-scatter_bytes"]
                         + out["all-to-all_bytes"]
                         + out["collective-permute_bytes"])
    return out


def _trip_count(cond_lines: list[str]) -> int:
    """Trip count from the loop condition: the largest compare constant."""
    best = 1
    for ln in cond_lines:
        if "compare" in ln or "constant" in ln:
            for c in _CONST_RE.findall(ln):
                best = max(best, int(c))
    return best


_OP_KINDS = (("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
             ("all_gather", "all-gather"), ("allgather", "all-gather"),
             ("reduce_scatter", "reduce-scatter"),
             ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
             ("send", "collective-permute"), ("recv", "collective-permute"))
_OP_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d")


def op_kind(namespace: str, name: str) -> str | None:
    """The collective kind of the op ``namespace::name``, or None."""
    if namespace not in _OP_NAMESPACES:
        return None
    return next((kind for part, kind in _OP_KINDS if part in name), None)


def collective_record(calls: list[tuple[str, int]]) -> dict:
    """The record :func:`analyze_collectives` gives, from the (kind, bytes)
    of each collective a step issued, in order."""
    out = {f"{c}_bytes": 0 for c in COLLECTIVES}
    out.update({f"{c}_count": 0 for c in COLLECTIVES})
    for kind, nbytes in calls:
        out[f"{kind}_bytes"] += nbytes
        out[f"{kind}_count"] += 1
    out["total_collective_bytes"] = sum(out[f"{c}_bytes"]
                                        for c in COLLECTIVES)
    out["total_collective_bytes_raw"] = out["total_collective_bytes"]
    # ring-collective wire bytes per device, as the reference's
    out["wire_bytes"] = (2 * out["all-reduce_bytes"]
                         + out["all-gather_bytes"]
                         + out["reduce-scatter_bytes"]
                         + out["all-to-all_bytes"]
                         + out["collective-permute_bytes"])
    return out


def trace_collectives(step, *args, **kwargs):
    """Run ``step(*args, **kwargs)`` under a dispatch mode that records each
    collective op it issues; returns (its output, :func:`collective_record`
    of them).  Works on real tensors and on meta tensors over a fake
    process group alike."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves as leaves

    import torch

    calls: list[tuple[str, int]] = []

    class _Accountant(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, a=(), kw=None):
            out = func(*a, **(kw or {}))
            kind = op_kind(func.namespace, func._opname)
            if kind is not None:
                # c10d::alltoall_base_ returns its Work alone: count the
                # output buffer it fills, its first argument
                ts = [t for t in leaves(out) if isinstance(t, torch.Tensor)] \
                    or a[:1]
                calls.append((kind, sum(t.numel() * t.element_size()
                                        for t in ts)))
            return out

    with _Accountant():
        out = step(*args, **kwargs)
    return out, collective_record(calls)
