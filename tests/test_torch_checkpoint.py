"""The port's checkpoint manager (``repro_torch.checkpoint.manager``),
mirroring ``tests/test_substrate.py``'s checkpoint tests: round trip, crc
corruption, an incomplete directory ignored, the async saver's GC; plus
torch leaves (bf16 through its bits), the JSON manifest's key paths, and
the async saver's copy to host before its thread starts."""
import json
import threading

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import manager as ckpt
from repro_torch.tree import tree_leaves


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": np.arange(10, dtype=np.float32),
            "b": {"c": np.ones((3, 4), np.int32), "d": np.float32(2.5)}}
    ckpt.save(tmp_path, 7, tree, extra={"note": "x"})
    assert ckpt.latest_step(tmp_path) == 7
    got, extra = ckpt.restore(tmp_path, 7, tree)
    assert extra["note"] == "x"
    for x, y in zip(tree_leaves(tree), tree_leaves(got)):
        np.testing.assert_array_equal(x, y)


def test_checkpoint_roundtrip_of_tensors(tmp_path):
    """Torch leaves in nested dicts and lists (the port's parameter
    layout), bf16 among them, come back bit for bit as CPU tensors; the
    manifest is JSON with each leaf's key path."""
    g = torch.Generator().manual_seed(0)
    tree = ({"embed": torch.randn((5, 3), generator=g),
             "stacks": {"s0": [{"w": torch.randn((2, 2), generator=g).to(
                 torch.bfloat16)}, {"w": torch.randn((2, 2), generator=g)
                                    .to(torch.bfloat16)}]}},
            {"step": torch.tensor(3, dtype=torch.int32)})
    d = ckpt.save(tmp_path, 2, tree)
    manifest = json.loads((d / "manifest.json").read_text())
    assert manifest["paths"] == ["/0/embed", "/0/stacks/s0/0/w",
                                 "/0/stacks/s0/1/w", "/1/step"]
    assert manifest["dtypes"] == ["float32", "bfloat16", "bfloat16",
                                  "int32"]
    got, _ = ckpt.restore(tmp_path, 2, tree)
    for x, y in zip(tree_leaves(tree), tree_leaves(got)):
        assert y.dtype == x.dtype and torch.equal(x, y)
    wrong = ({"embed": tree[0]["embed"]}, tree[1])
    with pytest.raises(ValueError, match="key paths"):
        ckpt.restore(tmp_path, 2, wrong)


def test_checkpoint_crc_detects_corruption(tmp_path):
    tree = {"a": np.arange(100, dtype=np.float32)}
    d = ckpt.save(tmp_path, 1, tree)
    part = next(d.glob("part_*.npz"))
    raw = bytearray(part.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    part.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="corruption"):
        ckpt.restore(tmp_path, 1, tree)


def test_checkpoint_incomplete_ignored(tmp_path):
    tree = {"a": np.arange(4, dtype=np.float32)}
    ckpt.save(tmp_path, 3, tree)
    bad = tmp_path / "step_00000009"
    bad.mkdir()                       # no DONE marker -> must be ignored
    (tmp_path / "step_00000011.tmp").mkdir()
    assert ckpt.latest_step(tmp_path) == 3


def test_async_saver_gc(tmp_path):
    s = ckpt.AsyncSaver(tmp_path, keep_last=2)
    tree = {"a": np.zeros(4, np.float32)}
    for step in (1, 2, 3, 4):
        s.save(step, tree)
    s.wait()
    s._gc()
    kept = sorted(p.name for p in tmp_path.glob("step_*"))
    assert kept == ["step_00000003", "step_00000004"]


def test_async_saver_copies_to_host_before_its_thread(tmp_path,
                                                      monkeypatch):
    """What the thread writes is the tree as it was when save() was called:
    a leaf changed afterwards does not reach the checkpoint."""
    gate = threading.Event()
    inner = ckpt.save

    def slow_save(*args, **kw):
        gate.wait(timeout=10)
        return inner(*args, **kw)

    monkeypatch.setattr(ckpt, "save", slow_save)
    w = torch.zeros(6)
    s = ckpt.AsyncSaver(tmp_path)
    s.save(5, {"w": w})
    w.add_(1.0)                       # training goes on
    gate.set()
    s.wait()
    got, _ = ckpt.restore(tmp_path, 5, {"w": w})
    assert torch.equal(got["w"], torch.zeros(6))
