"""Multi-pod dry run: trace every (arch x shape x mesh) cell on meta tensors
(port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell for 512 forced host devices.
The port runs one process per rank, so the dry run is one rank of the
production job: a fake process group of 256 or 512 ranks
(``torch.testing._internal.distributed.fake_pg``, whose collectives move
nothing), the production mesh over it, every argument a DTensor whose local
shard is a ``meta`` tensor (a shape, no storage), and the step traced once
as rank 0 runs it.  Nothing is allocated on any device.  For each cell it
records, in the reference's keys, into ``<out>/<cell>.json``:

* ``jaxpr_flops_global``: the global program's products, remat's
  recomputation included: the same step traced without a mesh at the
  global shapes (``flops_count``);
* ``cost.flops``: one rank's products on the mesh (``flops_count``): the
  attention, MLP, RG-LRU and xLSTM products and the unembedding split
  over ``model`` count a rank's share (where the q heads do not divide,
  minicpm-2b and arctic, its columns of the projections and flash over the
  heads they touch); the k / v projections where the kv heads do not
  divide but the q heads do, the unembedding of a vocabulary ``model``
  does not divide (minicpm-2b, whisper-medium) and the sLSTM's ``up`` /
  ``down`` (xlstm-350m's width 1,365) still repeat on every ``model``
  rank;
* ``collectives``: the collectives one rank issues, counted as they are
  dispatched (``hlo_analysis.trace_collectives``; the port's gathers and
  reductions, not GSPMD's plan): among them the two sums over ``model`` a
  layer (attention or the RG-LRU, and the MLP), the RG-LRU's gather of its
  conv output, the mLSTM's gathers (its ``u``; its q and k where a rank
  holds part of a head) and sum, the sLSTM's reduce-scatter and gather,
  the all-to-alls that move the mLSTM's states between their placement
  and the layout it computes in, attention's halo all-to-alls where the q
  heads do not divide (q, k and v a layer, and at prefill the ring's k and
  v to their slots), the embedding lookup's sum, the loss's
  two all-reduces a chunk or the greedy pick's one, and, at decode over a
  ring split by length, the gather of the q heads and the two all-reduces
  of the combine;
* ``memory``: ``argument_size_in_bytes`` and ``output_size_in_bytes``, the
  bytes of this rank's shards of the arguments and outputs;
  ``alias_size_in_bytes``, those of the arguments the step consumes (the
  reference's donated ones); ``temp_size_in_bytes``, the peak of the
  tensors live during the step (``MemTracker``, arguments included) less
  the arguments; ``generated_code_size_in_bytes`` 0, since nothing is
  compiled;
* ``lower_s``: the seconds of the traced step; ``compile_s`` 0.0 (nothing
  is compiled); ``n_devices``, the ranks.

The fake group is global to the process, so a caller that holds another
process group runs this in a subprocess.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-12b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod|--both-meshes]
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHS, SHAPES, get_config, shape_applicable
from repro_torch.tree import tree_leaves

from .flops_count import flops_global
from .hlo_analysis import trace_collectives
from .mesh import distribute_tree, make_production_mesh
from .specs import make_step_and_specs


def fake_group(world: int) -> None:
    """A fake process group of ``world`` ranks, this process rank 0 (an
    existing fake group of another size is replaced)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a {dist.get_backend()} process group is "
                               f"already initialized; run the dry run in a "
                               f"process of its own")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _locals(tree) -> list:
    """This rank's local tensor of each tensor leaf of ``tree``."""
    return [t.to_local() if isinstance(t, DTensor) else t
            for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def local_bytes(tree) -> int:
    """The bytes of this rank's shards of ``tree``'s tensors."""
    return sum(t.numel() * t.element_size() for t in _locals(tree))


def trace_step(step, args) -> tuple:
    """One run of ``step(*args)`` under ``MemTracker``, the flop counter and
    the collective accountant together: (its output, its FLOPs, the
    :func:`~.hlo_analysis.collective_record` of its collectives, the peak
    bytes of the tensors live during it, the arguments' shards included)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    tracker = MemTracker()
    tracker.track_external(*_locals(args))
    with tracker, FlopCounterMode(display=False) as counter:
        out, collectives = trace_collectives(step, *args)
    peak = tracker.get_tracker_snapshot("peak")
    return (out, counter.get_total_flops(), collectives,
            max((snap["Total"] for snap in peak.values()), default=0))


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: pathlib.Path,
             microbatches: int = 1, tag: str = "", policy: str = "2d") -> dict:
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    cell = f"{arch}__{shape}__{mesh_name}" + (f"__{tag}" if tag else "")
    cfg = get_config(arch)
    ok, reason = shape_applicable(cfg, shape)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name, "cell": cell,
           "microbatches": microbatches, "policy": policy}
    if not ok:
        rec.update(status="skipped", reason=reason)
        _write(out_dir, cell, rec)
        return rec
    try:
        fake_group(math.prod((2, 16, 16) if multi_pod else (16, 16)))
        mesh = make_production_mesh(multi_pod=multi_pod)
        step, args, in_pl, _, donate = make_step_and_specs(
            arch, shape, mesh, microbatches=microbatches, policy=policy)
        placed = tuple(distribute_tree(a, p, mesh)
                       for a, p in zip(args, in_pl))
        arg_bytes = local_bytes(placed)
        alias = local_bytes([placed[i] for i in donate])
        t0 = time.time()
        out, flops, collectives, peak = trace_step(step, placed)
        t_lower = time.time() - t0
        mem_rec = {"argument_size_in_bytes": arg_bytes,
                   "output_size_in_bytes": local_bytes(out),
                   "temp_size_in_bytes": peak - arg_bytes,
                   "generated_code_size_in_bytes": 0,
                   "alias_size_in_bytes": alias}
        rec.update(status="ok", lower_s=round(t_lower, 1), compile_s=0.0,
                   memory=mem_rec,
                   cost={"flops": float(flops)},
                   collectives=collectives,
                   jaxpr_flops_global=float(flops_global(
                       arch, shape, microbatches=microbatches)),
                   n_devices=mesh.size())
    except Exception as e:  # noqa: BLE001 -- record the failure, keep sweeping
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-4000:])
    _write(out_dir, cell, rec)
    return rec


def _write(out_dir: pathlib.Path, cell: str, rec: dict):
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{cell}.json").write_text(json.dumps(rec, indent=1))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--policy", default="2d", choices=["2d", "zero3", "tp"])
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args()
    out = pathlib.Path(args.out)

    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")
    meshes = [False, True] if (args.both_meshes or args.all) else \
        [args.multi_pod]

    n_ok = n_skip = n_err = 0
    for a, s in cells:
        for mp in meshes:
            # skip if already recorded (idempotent sweeps)
            mesh_name = "pod2x16x16" if mp else "pod16x16"
            cell = f"{a}__{s}__{mesh_name}" + (f"__{args.tag}" if args.tag
                                               else "")
            f = out / f"{cell}.json"
            if f.exists() and json.loads(f.read_text()).get("status") == "ok":
                print(f"[cached] {cell}")
                n_ok += 1
                continue
            rec = run_cell(a, s, mp, out, args.microbatches, args.tag,
                           args.policy)
            st = rec["status"]
            n_ok += st == "ok"
            n_skip += st == "skipped"
            n_err += st == "error"
            extra = ""
            if st == "ok":
                extra = (f"trace={rec['lower_s']}s "
                         f"flops={rec['cost']['flops']:.3e} "
                         f"coll={rec['collectives']['total_collective_bytes']:.3e}B")
            elif st == "error":
                extra = rec["error"][:200]
            print(f"[{st}] {cell} {extra}", flush=True)
    print(f"done: ok={n_ok} skipped={n_skip} errors={n_err}")
    if dist.is_initialized():
        dist.destroy_process_group()
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
