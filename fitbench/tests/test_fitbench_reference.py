"""The plain reference against brute-force counting."""
from __future__ import annotations

import numpy as np
import pytest

from fitbench import reference


def brute(live, q, verb, absent):
    live = list(live)
    out = []
    for x in q:
        left = sum(k < x for k in live)
        right = sum(k <= x for k in live)
        if verb == "right":
            out.append(right)
        elif verb == "left" or absent is None:
            out.append(left)
        else:
            out.append(left if right > left else absent)
    return np.asarray(out, np.int64)


@pytest.mark.parametrize("verb", ["lookup", "left", "right"])
@pytest.mark.parametrize("absent", [-1, None])
def test_ranks_equal_brute_force_with_duplicate_runs(verb, absent):
    r = np.random.default_rng(7)
    col = np.sort(r.integers(0, 12, 40).astype(np.float64))  # long runs
    q = np.concatenate([col, np.arange(-2, 15, dtype=np.float64)])
    np.testing.assert_array_equal(reference.ranks(col, q, verb, absent),
                                  brute(col, q, verb, absent))


def test_ranks_on_an_empty_column():
    q = np.array([-1.0, 0.0, 3.0])
    np.testing.assert_array_equal(reference.ranks(np.empty(0), q, "lookup",
                                                  -1), [-1, -1, -1])
    np.testing.assert_array_equal(reference.ranks(np.empty(0), q, "right",
                                                  -1), [0, 0, 0])


@pytest.mark.parametrize("absent", [-1, None])
def test_an_unknown_verb_is_refused(absent):
    with pytest.raises(ValueError):
        reference.ranks(np.arange(3.0), np.array([1.0]), "range", absent)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_history_equals_replaying_the_inserts(seed):
    r = np.random.default_rng(seed)
    base = np.sort(r.integers(0, 20, 60).astype(np.float64))
    n = 120
    inserts = r.integers(0, 25, n).astype(np.float64)
    hist = reference.History(base, inserts)
    assert hist.n_ops == n
    live = list(base)
    for w in range(n + 1):
        np.testing.assert_array_equal(hist.live(w), np.sort(live))
        if w < n:
            live.append(inserts[w])
