"""Runs for the batched ShrinkingCone (``repro_torch.kernels.shrinking_cone``):
its host twin and its CUDA kernel are held on these to ``shrinking_cone``
run by run.  Imports neither JAX nor the JAX package, so the card's tests
share them."""
from __future__ import annotations

import numpy as np

from repro_torch.core.datasets import iot_like, weblogs_like
from repro_torch.core.tree import FITingTree

MODES = ("paper", "clamped")


def _runs(*runs) -> tuple[np.ndarray, np.ndarray]:
    keys = np.concatenate([np.asarray(r, np.float64) for r in runs])
    return keys, np.cumsum([0] + [len(r) for r in runs]).astype(np.int64)


def cone_cases() -> dict[str, tuple[np.ndarray, np.ndarray, int]]:
    """name -> (flat keys, run offsets, error): runs of 1 and 2 keys,
    all-duplicate runs, subnormal key spans (slopes overflow), runs past a
    warp's 32 keys and past 10^5, error 0."""
    rng = np.random.default_rng(7)

    def uniform(n, hi=1e6):
        return np.sort(rng.uniform(0.0, hi, n))

    tiny = 5e-324                                     # the least subnormal
    return {
        "short runs": (*_runs(uniform(1), uniform(2), [7.0], uniform(3),
                              [5.0, 5.0], [1.0, 2.0]), 4),
        "all duplicates": (*_runs(np.full(200, 3.0), np.full(17, 9.0),
                                  [9.0], np.repeat([1.0, 2.0, 4.0], 50)), 16),
        "subnormal spans": (*_runs(np.arange(300) * tiny,
                                   1e-308 + np.arange(100) * tiny,
                                   np.sort(rng.integers(0, 50, 200)) * tiny),
                            8),
        "past a warp": (*_runs(uniform(33), uniform(64),
                               np.floor(uniform(97, 300))), 2),
        "past 1e5": (*_runs(iot_like(100_001, seed=3), uniform(5)), 64),
        "error 0": (*_runs(np.sort(rng.integers(0, 100, 500)), uniform(40)),
                    0),
    }


def weblogs_tree(n: int, inserts: int, seed: int = 0, error: int = 64,
                 buffer_size: int = 16, mode: str = "paper") -> FITingTree:
    """A FITingTree over ``n`` Weblogs-shaped integer keys (the benchmark's
    ~1.8 keys a value) with ``inserts`` buffered keys, 3/4 copies of its
    keys and 1/4 uniform over its range: a shard before a publish."""
    t = weblogs_like(n, seed=seed)
    keys = np.floor((t - t[0]) * (n / max(t[-1] - t[0], 1.0)))
    rng = np.random.default_rng(seed + 1)
    copies = inserts * 3 // 4
    new = np.concatenate([keys[rng.integers(0, n, copies)],
                          np.floor(rng.uniform(0, n, inserts - copies))])
    rng.shuffle(new)
    tree = FITingTree(keys, error=error, buffer_size=buffer_size, mode=mode,
                      assume_sorted=True)
    tree.insert_many(new)
    return tree
