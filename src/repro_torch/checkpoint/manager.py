"""Checkpointing: npz parts + JSON manifest, async, atomic (port of
``repro.checkpoint.manager``).

Layout:  <dir>/step_<N>/part_<k>.npz + manifest.json + DONE marker.
  * atomic: written to step_<N>.tmp, fsync'd, renamed; readers only trust
    directories with a DONE marker -> a killed writer never corrupts state.
  * logical arrays: leaves are saved whole on the host; ``AsyncSaver``
    gathers a DTensor (``full_tensor``, a collective: every rank of its
    mesh saves, and a saver made with ``write=False`` gathers without
    writing); ``restore``
    returns a tree shaped like the one given, its leaves on the host, and
    the caller moves them to its device, except where the tree given holds
    DTensors: there each rank gets its shard of the logical array on
    whatever mesh and placement the given leaf has (the reference's
    elastic restore: a checkpoint of one rank resumes on four, and the
    other way round).
  * async: ``AsyncSaver.save`` copies every leaf to the host (CUDA tensors
    included) before its background thread starts, so training may go on
    and replace its buffers; the previous async save is joined first, so
    at most one is in flight.
  * integrity: per-part crc32 in the manifest, verified on restore.

Two departures from the reference: the manifest is JSON
(``manifest.json``), not msgpack, since the port must not depend on a
package the card's machine lacks; and it records each leaf's key path
(``tree.tree_paths``) where the reference records ``str(treedef)``, and
``restore`` checks them against the tree it is given.  Leaves may be numpy
arrays, numpy or Python scalars, or torch tensors; bf16 tensors are stored
as their 16-bit patterns and come back as bf16 tensors.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
import zlib
from typing import Any

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.models import act_ctx
from repro_torch.tree import tree_leaves, tree_map, tree_paths, \
    tree_unflatten

_BF16 = "bfloat16"


def _host(leaf: Any) -> Any:
    """A leaf as it will be saved: tensors copied to host memory, a
    DTensor's logical tensor gathered first."""
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.asarray(leaf)


def _array(leaf: Any) -> tuple[np.ndarray, str]:
    """(the array written to the npz, the dtype recorded for it)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), _BF16
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(ckpt_dir: str | os.PathLike, step: int, tree: Any,
         extra: dict | None = None, parts: int = 4) -> pathlib.Path:
    ckpt_dir = pathlib.Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    pairs = [_array(leaf) for leaf in tree_leaves(tree)]
    arrays = [a for a, _ in pairs]
    groups: list[list[int]] = [[] for _ in range(parts)]
    sizes = [0] * parts
    for i, a in enumerate(arrays):       # greedy size-balance across parts
        j = sizes.index(min(sizes))
        groups[j].append(i)
        sizes[j] += a.nbytes
    crcs = {}
    for j, idxs in enumerate(groups):
        path = tmp / f"part_{j}.npz"
        np.savez(path, **{f"leaf_{i}": arrays[i] for i in idxs})
        crcs[f"part_{j}.npz"] = zlib.crc32(path.read_bytes())
    manifest = {
        "step": step,
        "paths": tree_paths(tree),
        "n_leaves": len(arrays),
        "leaf_part": {str(i): j for j, idxs in enumerate(groups)
                      for i in idxs},
        "shapes": [list(a.shape) for a in arrays],
        "dtypes": [dt for _, dt in pairs],
        "crc32": crcs,
        "extra": extra or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    (tmp / "DONE").write_text("ok")
    for f in tmp.iterdir():              # fsync before rename
        fd = os.open(f, os.O_RDONLY)
        os.fsync(fd)
        os.close(fd)
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return final


class AsyncSaver:
    """``write=False``: a rank that takes part in gathering a sharded tree
    and leaves the writing to another (every rank but the first)."""

    def __init__(self, ckpt_dir, keep_last: int = 3, write: bool = True):
        self.ckpt_dir = pathlib.Path(ckpt_dir)
        self.keep_last = keep_last
        self.write = write
        self._thread: threading.Thread | None = None

    def save(self, step: int, tree: Any, extra: dict | None = None):
        self.wait()
        # copy to host *now*, so training can replace its buffers; gathering
        # a DTensor is a collective, so it happens here, on every rank, and
        # never in the writer thread
        host = tree_map(_host, tree)
        if not self.write:
            return

        def run():
            save(self.ckpt_dir, step, host, extra)
            self._gc()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(self.ckpt_dir.glob("step_*"))
        steps = [s for s in steps if (s / "DONE").exists()]
        for s in steps[: -self.keep_last]:
            shutil.rmtree(s, ignore_errors=True)


def latest_step(ckpt_dir) -> int | None:
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    done = [int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")
            if (p / "DONE").exists() and not p.name.endswith(".tmp")]
    return max(done) if done else None


def restore(ckpt_dir, step: int, like: Any) -> tuple[Any, dict]:
    """Returns (tree shaped like ``like``, extra).  Verifies crc32 and the
    key paths.  A leaf comes back as a CPU tensor where ``like`` has a
    tensor, as this rank's shard of it placed as ``like``'s where that is
    a DTensor, else as a numpy array."""
    d = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    for name, crc in manifest["crc32"].items():
        got = zlib.crc32((d / name).read_bytes())
        if got != crc:
            raise IOError(f"checkpoint corruption: {name} crc {got} != {crc}")
    if manifest["paths"] != tree_paths(like):
        raise ValueError(f"checkpoint {d} holds another tree: its key paths "
                         f"differ from the one given")
    parts = {j: np.load(d / f"part_{j}.npz")
             for j in set(manifest["leaf_part"].values())}
    leaves = []
    for i, want in enumerate(tree_leaves(like)):
        arr = parts[manifest["leaf_part"][str(i)]][f"leaf_{i}"]
        if not isinstance(want, torch.Tensor):
            leaves.append(arr)
            continue
        t = torch.from_numpy(arr)
        if manifest["dtypes"][i] == _BF16:
            t = t.view(torch.bfloat16)
        if isinstance(want, DTensor):
            t = act_ctx.distribute(t.to(want.device), want.device_mesh,
                                   want.placements)
        leaves.append(t)
    return tree_unflatten(like, leaves), manifest.get("extra", {})
