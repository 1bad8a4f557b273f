"""The plain reference: NumPy ``searchsorted`` over the live sorted multiset.

Independent of the program: it imports nothing of it and reads nothing it
made.  It is handed the key column and the write stream the benchmark
generated, and works the live multiset out again itself.

Verbs: ``"left"`` / ``"right"`` are ``np.searchsorted`` ranks; ``"lookup"``
is the leftmost rank of the query, and where the configuration states
``lookup_absent == -1`` it is -1 for a query that is not a live key (the
LSM service states the leftmost rank instead).

A write stream is the inserted keys in the order they were acknowledged,
each one occurrence more of its key.  A read made after the first ``w``
inserts sees exactly them.
"""
from __future__ import annotations

import numpy as np

VERBS = ("lookup", "left", "right")


def ranks(live: np.ndarray, queries: np.ndarray, verb: str,
          lookup_absent: int | None) -> np.ndarray:
    """Answers of ``verb`` over the sorted live keys ``live``."""
    if verb not in VERBS:
        raise ValueError(f"unknown verb {verb!r}")
    q = np.asarray(queries, np.float64)
    if verb == "right":
        return np.searchsorted(live, q, "right").astype(np.int64)
    left = np.searchsorted(live, q, "left").astype(np.int64)
    if verb == "left" or lookup_absent is None:
        return left
    n = live.shape[0]
    hit = (left < n) & (live[np.minimum(left, n - 1)] == q) if n else \
        np.zeros(q.shape, bool)
    return np.where(hit, left, np.int64(lookup_absent))


class History:
    """A sorted base column and the keys inserted after it, in the order
    they were acknowledged: the live multiset after any prefix of them."""

    def __init__(self, base: np.ndarray, inserts: np.ndarray | None = None):
        self.base = np.asarray(base, np.float64)
        self.inserts = np.empty(0) if inserts is None else \
            np.asarray(inserts, np.float64)

    @property
    def n_ops(self) -> int:
        return int(self.inserts.size)

    def live(self, w: int) -> np.ndarray:
        """The sorted live multiset after the first ``w`` inserts."""
        ins = np.sort(self.inserts[:w])
        if not ins.size:
            return self.base
        return np.insert(self.base, np.searchsorted(self.base, ins), ins)
