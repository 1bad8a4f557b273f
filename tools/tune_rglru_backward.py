#!/usr/bin/env python3
"""Time variants of the RG-LRU scan's backward TMA kernel on one CUDA card.

Each variant is ``csrc/rglru_scan.cu`` with its ring's depth
(``kBwdStages``) and its tile's length in time steps (``kTileT``) replaced,
built with the same ``nvcc`` flags as the port (all at once, into
``src/repro_torch/_build/tune/``) and launched through its own
``rglru_scan_bwd_tma_launch``.  Tiles stay 32 channels wide: a wider tile
leaves SMs idle at B 2, W 4,096 (128 blocks for 132 SMs).  At each shape
every variant's du and da must equal the committed kernel's
(``torch.equal``); then each is timed by CUDA events, one call (median of
25) and in bursts of 20, in turns (the variants in order, then reversed).
Run from the repository root:

    python3 tools/tune_rglru_backward.py
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
VARIANTS = [(s, t) for t in (64, 32) for s in (2, 3, 4)]   # (stages, kTileT)
SHAPES = (("headline", 4, 4096, 4096), ("training", 2, 2048, 4096))


def build(variant, csrc: Path, out_dir: Path, nvcc: str, flags) -> Path:
    stages, tile_t = variant
    src = csrc.read_text()
    for name, value in (("kBwdStages", stages), ("kTileT", tile_t)):
        src, n = re.subn(rf"constexpr int {name} = \d+;",
                         f"constexpr int {name} = {value};", src)
        if n != 1:
            raise RuntimeError(f"{name} not found once in {csrc}")
    cu = out_dir / f"bwd_s{stages}_t{tile_t}.cu"
    cu.write_text(src)
    lib = cu.with_suffix(".so")
    proc = subprocess.run([nvcc, *flags, "-o", str(lib), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {cu.name}:\n{proc.stderr}")
    regs = [ln.strip() for ln in proc.stderr.splitlines()
            if "registers" in ln or "spill" in ln]
    print(f"{cu.name}: " + " | ".join(regs[-4:]), flush=True)
    return lib


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("tune_rglru_backward: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.rglru_scan import (rglru_scan_backward_cuda,
                                                rglru_scan_cuda)
    sys.path.insert(0, str(ROOT))
    from chip_smoke import burst_ms, card_line, median_ms
    card = card_line()
    out_dir = _build.BUILD_DIR / "tune"
    out_dir.mkdir(parents=True, exist_ok=True)
    csrc = _build.CSRC / "rglru_scan.cu"
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = list(pool.map(lambda v: build(v, csrc, out_dir, _build.nvcc(),
                                             _build.NVCC_FLAGS), VARIANTS))
    launchers = []
    for lib in libs:
        fn = ctypes.CDLL(str(lib)).rglru_scan_bwd_tma_launch
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 \
            + [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
        launchers.append(fn)
    dev = torch.device("cuda", 0)
    rows = []
    for name, b, t, w in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(7)
        u = torch.randn((b, t, w), generator=gen, device=dev)
        a = torch.rand((b, t, w), generator=gen, device=dev)
        g = torch.randn((b, t, w), generator=gen, device=dev)
        h, _ = rglru_scan_cuda(u, a)
        want = rglru_scan_backward_cuda(g, a, h)

        def call(fn, g=g, a=a, h=h, b=b, t=t, w=w):
            du, da = torch.empty_like(g), torch.empty_like(g)
            err = fn(g.data_ptr(), a.data_ptr(), h.data_ptr(), b, t, w,
                     du.data_ptr(), da.data_ptr(),
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")
            return du, da

        times = {v: [] for v in VARIANTS}
        for order in (VARIANTS, VARIANTS[::-1]):
            for v in order:
                fn = launchers[VARIANTS.index(v)]
                got = call(fn)
                torch.cuda.synchronize()
                if not all(map(torch.equal, got, want)):
                    raise AssertionError(f"variant {v} at {name} differs "
                                         f"from the committed kernel")
                times[v].append((median_ms(torch, lambda: call(fn)),
                                 burst_ms(torch, lambda: call(fn))))
        bound = 5 * b * t * w * 4 / 3.35e12 * 1e3
        for v, ts in times.items():
            ms = sum(x for x, _ in ts) / len(ts)
            bms = sum(y for _, y in ts) / len(ts)
            row = {"shape": name, "b": b, "t": t, "w": w, "stages": v[0],
                   "tile_t": v[1], "ms": ms, "burst_ms": bms,
                   "bound_ms": bound, "share": bound / ms,
                   "burst_share": bound / bms}
            rows.append(row)
            print(f"{name} B={b} T={t} W={w}: stages {v[0]}, tile {v[1]} "
                  f"steps x 32 channels: one call {ms:.4f} ms "
                  f"({row['share']:.1%} of the {bound:.4f} ms bound), "
                  f"bursts {bms:.4f} ms ({row['burst_share']:.1%}) "
                  f"[{card}]", flush=True)
        del u, a, g, h, want
        torch.cuda.empty_cache()
    print(f"card: {card}")
    print(json.dumps({"variants": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
