"""Run by ``tests/test_torch_hlo_analysis.py`` in a subprocess:

    PYTHONPATH=src python tests/_torch_collectives_job.py DIR

Four ``gloo`` ranks on a 2 x 2 ("data", "model") mesh (a ``FileStore``
under DIR) run one tiny step under ``hlo_analysis.trace_collectives`` and
write rank 0's record to DIR/collectives.json.  The step issues, by hand:

* a (8, 12) f32 DTensor sharded over ``data`` redistributed to
  ``Replicate``: one all-gather over the 2 ``data`` ranks, returning
  8 x 12 x 4 = 384 bytes;
* a (4, 6) f32 DTensor ``Partial`` over ``model`` redistributed to
  ``Replicate``: one all-reduce of 4 x 6 x 4 = 96 bytes;
* a (8, 6) f32 DTensor ``Partial`` over ``data`` redistributed to
  ``Shard(0)``: one reduce-scatter returning its (4, 6) shard, 96 bytes;
* ``torch.distributed.all_reduce`` of 10 f32: one all-reduce of 40 bytes;
* ``torch.distributed.all_to_all_single`` of 8 f32 (2 to each rank): one
  all-to-all filling 8 x 4 = 32 bytes (the op returns no tensor: its
  output buffer is counted).
"""
import json
import os
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.launch.hlo_analysis import trace_collectives


def step(mesh):
    a = DTensor.from_local(torch.ones(4, 12), mesh, [Shard(0), Replicate()])
    a = a.redistribute(mesh, [Replicate(), Replicate()]).to_local()
    b = DTensor.from_local(torch.ones(4, 6), mesh, [Replicate(), Partial()])
    b = b.redistribute(mesh, [Replicate(), Replicate()]).to_local()
    c = DTensor.from_local(torch.ones(8, 6), mesh, [Partial(), Replicate()])
    c = c.redistribute(mesh, [Shard(0), Replicate()]).to_local()
    d = torch.ones(10)
    dist.all_reduce(d)
    e = torch.empty(8)
    dist.all_to_all_single(e, torch.full((8,), float(dist.get_rank())))
    return [a.shape, b.shape, c.shape, float(a.sum()), float(b.sum()),
            float(c.sum()), float(d.sum()), float(e.sum())]


def rank_main(rank: int, world: int, d: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/store",
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        out, rec = trace_collectives(step, mesh)
        if rank == 0:
            with open(os.path.join(d, "collectives.json"), "w") as f:
                json.dump({"record": rec,
                           "out": [list(x) if isinstance(x, torch.Size)
                                   else x for x in out]}, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    mp.spawn(rank_main, args=(4, sys.argv[1]), nprocs=4, join=True)
