"""The port's read path as a whole against the JAX package's.

``Snapshot.from_arrays`` + ``ServingHandle`` in both packages serve the same
keys and payload (made from a seed with numpy), and every verb -- lookup,
search on both sides, point, count, range, predecessor, successor -- answers
alike on every backend and equals ``np.searchsorted`` on the column.  Ranks
are integers and every compare is exact (integer keys, f32-exact queries), so
the tolerance is 0.  Ranges are ``[lo, hi]`` inclusive; duplicated keys answer
with the leftmost rank (the rightmost for ``predecessor``).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import jax_index as ref_jax_index
from repro.index import ServingHandle as RefHandle
from repro.index import Snapshot as RefSnapshot
from repro.kernels import ops as ref_ops
from repro_torch.core import torch_index
from repro_torch.index import ServingHandle, Snapshot
from repro_torch.kernels import ops

SRC = Path(__file__).resolve().parent.parent / "src"
DISPATCH = {"small_max": 2, "large_min": 100}
# port backend -> the reference's; dispatch keeps its name, its tiers map too
PAIRS = [("numpy", "numpy"), ("torch-window", "xla-window"),
         ("torch-bisect", "xla-bisect"), ("cuda", "pallas"),
         ("dispatch", "dispatch")]


def _keys(seed=0, n=4000):
    """Integer keys with heavy duplicate runs, some longer than a window."""
    rng = np.random.default_rng(seed)
    ks = np.concatenate([rng.choice(2 ** 16, n, replace=True) * 3,
                         np.full(300, 3 * 2 ** 15)])
    return np.sort(ks).astype(np.float64)


def _handles(keys, error, payload=None, epoch=1):
    cpu = {"device": "cpu"}
    ours = ServingHandle(engine_opts={
        "dispatch": {**DISPATCH, **cpu}, "torch-window": cpu,
        "torch-bisect": cpu, "cuda": cpu})
    ref = RefHandle(engine_opts={"dispatch": dict(DISPATCH)})
    ours.install(Snapshot.from_arrays(keys, error, payload=payload,
                                      epoch=epoch))
    ref.install(RefSnapshot.from_arrays(keys, error, payload=payload,
                                        epoch=epoch))
    return ours, ref


def _points(keys, rng, m=120):
    return np.concatenate([
        keys[rng.integers(0, keys.shape[0], m)],
        keys[rng.integers(0, keys.shape[0], m // 2)] + 1.0,   # gaps
        [keys[0] - 1.0, keys[-1] + 1.0, -1e6, 1e6, 3.0 * 2 ** 15]])


@pytest.mark.parametrize("backend,ref_backend", PAIRS)
def test_every_verb_matches_reference_and_oracle(backend, ref_backend):
    """A full batch and a batch of two (the dispatch backend's small tier):
    the port answers each as a batch of its own, against the prefix of the
    reference's and the oracle's answers to the full batch."""
    keys = _keys(seed=1)
    n = keys.shape[0]
    ours, ref = _handles(keys, 32)
    rng = np.random.default_rng(2)
    q = _points(keys, rng)
    hi = q + rng.integers(-50, 3000, q.shape[0])          # some inverted
    left = np.searchsorted(keys, q, "left")
    right = np.searchsorted(keys, q, "right")
    found = (left < n) & (keys[np.minimum(left, n - 1)] == q)
    want = {
        "search left": (ref.search(q, "left", backend=ref_backend), left),
        "search right": (ref.search(q, "right", backend=ref_backend), right),
        "lookup": (ref.lookup(q, backend=ref_backend),
                   np.where(found, left, -1)),
        "count": (ref.count(q, hi, backend=ref_backend),
                  np.maximum(np.searchsorted(keys, hi, "right") - left, 0))}
    for verb, oracle in (
            ("point", (np.where(found, left, -1), found)),
            ("predecessor", (np.where(right > 0, right - 1, -1), right > 0)),
            ("successor", (np.where(left < n, left, -1), left < n))):
        res = getattr(ref, verb)(q, backend=ref_backend)
        want[verb + ".rank"] = (res.rank, oracle[0])
        want[verb + ".found"] = (res.found, oracle[1])
    for size in (q.shape[0], 2):
        qs = q[:size]
        got = {"search left": ours.search(qs, "left", backend=backend),
               "search right": ours.search(qs, "right", backend=backend),
               "lookup": ours.lookup(qs, backend=backend),
               "count": ours.count(qs, hi[:size], backend=backend)}
        for verb in ("point", "predecessor", "successor"):
            res = getattr(ours, verb)(qs, backend=backend)
            got[verb + ".rank"], got[verb + ".found"] = res.rank, res.found
        assert got.keys() == want.keys()
        for name, (ref_got, oracle) in want.items():
            what = f"{name}, batch of {size}"
            np.testing.assert_array_equal(got[name], ref_got[:size],
                                          err_msg=f"{what} vs ref")
            np.testing.assert_array_equal(got[name], oracle[:size],
                                          err_msg=f"{what} vs oracle")


@pytest.mark.parametrize("backend,ref_backend", PAIRS)
def test_ranges_with_payload_match_reference(backend, ref_backend):
    keys = _keys(seed=3)
    payload = np.arange(keys.shape[0]) * 10
    ours, ref = _handles(keys, 16, payload=payload)
    rng = np.random.default_rng(4)
    bounds = [tuple(np.sort(rng.choice(keys, 2))) for _ in range(6)]
    bounds += [(keys[9] + 1.0, keys[9] + 1.0),            # empty gap
               (keys[200], keys[100] - 1.0),             # inverted
               (keys[-1] + 5.0, keys[-1] + 9.0),         # above the domain
               (keys[0] - 9.0, keys[0] - 5.0),           # below it
               (-1e9, 1e9), (3.0 * 2 ** 15, 3.0 * 2 ** 15)]  # all; a long run
    for lo, hi in bounds:
        a = ours.range(lo, hi, backend=backend)
        b = ref.range(lo, hi, backend=ref_backend)
        lo_r = int(np.searchsorted(keys, lo, "left"))
        hi_r = max(int(np.searchsorted(keys, hi, "right")), lo_r)
        assert (a.lo_rank, a.hi_rank) == (b.lo_rank, b.hi_rank) == (lo_r,
                                                                     hi_r)
        assert a.count == b.count and a.empty == b.empty
        np.testing.assert_array_equal(a.keys, b.keys)
        np.testing.assert_array_equal(a.keys, keys[lo_r:hi_r])
        np.testing.assert_array_equal(a.payload, b.payload)
        np.testing.assert_array_equal(a.payload, payload[lo_r:hi_r])
    bare = ours.range(1.0, 2.0, materialize=False, backend=backend)
    assert bare.keys is None and bare.payload is None
    with pytest.raises(ValueError, match="NaN"):
        ours.range(float("nan"), 1.0, backend=backend)


@pytest.mark.parametrize("backend,ref_backend", PAIRS)
def test_empty_snapshot_answers_every_verb(backend, ref_backend):
    ours, ref = _handles(np.empty(0), 8)
    q = np.array([1.0, 2.0])
    for side in ("left", "right"):
        np.testing.assert_array_equal(ours.search(q, side, backend=backend),
                                      ref.search(q, side, backend=ref_backend))
    np.testing.assert_array_equal(ours.lookup(q, backend=backend), [-1, -1])
    assert not ours.point(q, backend=backend).found.any()
    np.testing.assert_array_equal(ours.count(q, q + 1, backend=backend),
                                  [0, 0])
    res = ours.range(0.0, 10.0, backend=backend)
    assert res.empty and res.keys.shape[0] == 0
    assert not ours.predecessor(q, backend=backend).found.any()
    assert not ours.successor(q, backend=backend).found.any()


def test_install_swaps_epochs_and_retires_engines():
    keys = _keys(seed=5)
    ours, _ = _handles(keys, 16, epoch=1)
    with pytest.raises(RuntimeError, match="no snapshot"):
        ServingHandle().current()
    eng = ours.engine("cuda")
    assert ours.engine("cuda") is eng and ours.epoch == 1
    snap = Snapshot.from_arrays(keys[::2], 16, epoch=2)
    ours.install(snap)
    assert ours.epoch == 2 and ours.current() is snap
    assert ours.engine("cuda") is not eng
    np.testing.assert_array_equal(ours.search(keys, "left", backend="cuda"),
                                  np.searchsorted(keys[::2], keys, "left"))
    assert not snap.table.keys.flags.writeable


def test_handle_verbs_default_to_the_card_and_raise_without_one(monkeypatch):
    """No verb quietly serves from the host: without a backend named, each
    goes to the ``cuda`` backend, whose default device is the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    handle = ServingHandle()
    handle.install(Snapshot.from_arrays(_keys(seed=11, n=500), 16))
    q = np.array([3.0, 6.0])
    for verb in (lambda: handle.engine(), lambda: handle.lookup(q),
                 lambda: handle.search(q), lambda: handle.search(q, "right"),
                 lambda: handle.point(q), lambda: handle.count(q, q + 9),
                 lambda: handle.range(0.0, 9.0),
                 lambda: handle.predecessor(q), lambda: handle.successor(q)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            verb()
    np.testing.assert_array_equal(handle.search(q, backend="numpy"),
                                  np.searchsorted(handle.current().table.keys,
                                                  q))


def test_torch_index_wrappers_match_jax_index():
    keys = _keys(seed=6)
    ref_idx = ref_jax_index.build_device_index(keys, 16)
    idx = torch_index.build_device_index(keys, 16, device="cpu")
    rng = np.random.default_rng(7)
    q = _points(keys, rng)
    lo, hi = q, q + rng.integers(-10, 500, q.shape[0])
    tq, jq = torch.tensor(q, dtype=torch.float32), jnp.asarray(q, jnp.float32)
    th, jh = torch.tensor(hi, dtype=torch.float32), jnp.asarray(hi,
                                                                jnp.float32)
    np.testing.assert_array_equal(torch_index.predict_positions(idx, tq),
                                  ref_jax_index.predict_positions(ref_idx, jq))
    for strategy in ("window", "bisect"):
        np.testing.assert_array_equal(
            torch_index.lookup(idx, tq, strategy),
            ref_jax_index.lookup(ref_idx, jq, strategy))
    for side in ("left", "right"):
        np.testing.assert_array_equal(torch_index.bound(idx, tq, side),
                                      ref_jax_index.bound(ref_idx, jq, side))
    np.testing.assert_array_equal(
        torch_index.range_count(idx, tq, th),
        ref_jax_index.range_count(ref_idx, jq, jh))
    raw = np.sort(np.random.default_rng(8).lognormal(0, 2, 500))
    for a, b in zip(torch_index.rescale_keys(raw),
                    ref_jax_index.rescale_keys(raw), strict=True):
        np.testing.assert_array_equal(a, b)


def test_ops_fitting_lookup_matches_reference_ops():
    keys = _keys(seed=9)
    ref_idx = ref_jax_index.build_device_index(keys, 64)
    idx = torch_index.build_device_index(keys, 64, device="cpu")
    q = _points(keys, np.random.default_rng(10))
    got = ops.make_lookup_fn(idx)(torch.tensor(q, dtype=torch.float32))
    want = ref_ops.fitting_lookup(ref_idx, jnp.asarray(q, jnp.float32),
                                  interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import repro_torch.index.engine, repro_torch.core.torch_index\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m == 'repro'\n"
        "             or m.startswith(('jax.', 'jaxlib', 'repro.')))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env={**os.environ, "PYTHONPATH": str(SRC)},
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
