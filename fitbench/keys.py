"""The benchmark's own generators: key columns, query batches, write streams.

Frozen copies, kept here so that a change to the program cannot change the
yardstick:

* ``thinned``: the inhomogeneous Poisson thinning sampler behind the
  paper's IoT and Weblogs shapes (FITing-Tree, Sec. 7.1.1), in torch so that
  a 2^24-key column is drawn on the card from one generator.
* ``integer_column``: the affine rescale to ``[0, domain]`` and the floor,
  so every key is an integer that float32 holds exactly (``domain <= 2^24``).
* ``column_queries``: 3/4 keys drawn from the column, 1/4 uniform integers.
* ``insert_keys``: 3/4 copies of column keys, 1/4 uniform integers.

Every draw takes its randomness from :func:`rng` / :func:`torch_generator`,
keyed by the run's seed and a stream number, so the same seed gives the same
inputs and the streams do not depend on one another.
"""
from __future__ import annotations

import numpy as np

F32_EXACT = 2 ** 24          # the largest integer domain float32 holds exactly

# stream numbers: one independent generator per purpose
STREAM_KEYS, STREAM_READS, STREAM_WRITES, STREAM_SAMPLE, STREAM_READBACK = \
    1, 2, 3, 4, 5


def seed_words(seed: int, stream: int, *more: int) -> list[int]:
    """The entropy of one stream: the seed as 32-bit words (any whole number,
    negative ones folded into 64 bits), the stream number and any further
    index (a chunk of a stream)."""
    s = int(seed) % 2 ** 64
    return [stream, s & 0xFFFFFFFF, s >> 32, *more]


def rng(seed: int, stream: int, *more: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(
        seed_words(seed, stream, *more)))


def torch_generator(torch, seed: int, stream: int, device):
    """A torch generator on ``device`` seeded from (seed, stream)."""
    words = np.random.SeedSequence(seed_words(seed, stream)).generate_state(
        2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(words[0]) << 31) ^ int(words[1]))
    return gen


def thinned(torch, n: int, rate_fn, t_end: float, rate_max: float, gen,
            device):
    """~n sorted event times in [0, t_end] of a Poisson process whose rate is
    ``rate_fn(t) <= rate_max``, by thinning: uniform candidates kept with
    probability rate / rate_max, then exactly n taken at evenly spaced ranks
    (float64 on ``device``)."""
    kw = {"generator": gen, "device": device, "dtype": torch.float64}
    out = torch.empty(0, **{k: kw[k] for k in ("device", "dtype")})
    m = int(n * 1.3) + 64
    while out.shape[0] < n:
        cand = torch.rand(m, **kw) * t_end
        keep = torch.rand(m, **kw) * rate_max < rate_fn(torch, cand)
        out = torch.cat([out, cand[keep]])
        m = max(1024, int((n - out.shape[0]) * 2.5))
    out = torch.sort(out).values
    idx = torch.linspace(0, out.shape[0] - 1, n, device=device,
                         dtype=torch.float64).long()
    return out[idx]


def integer_column(torch, times, domain: int) -> np.ndarray:
    """Affine map onto [0, domain] and floor: sorted float64 integers that
    float32 holds exactly, returned on the host."""
    if domain > F32_EXACT:
        raise ValueError(f"domain {domain} > 2^24 is not exact in float32")
    lo, hi = times[0], times[-1]
    scale = domain / torch.clamp(hi - lo, min=1.0)
    keys = torch.floor((times - lo) * scale).clamp_(0, domain)
    out = keys.cpu().numpy().astype(np.float64)
    if np.any(np.diff(out) < 0):
        raise AssertionError("the key column is not sorted")
    return out


def column_queries(keys: np.ndarray, size: int, r: np.random.Generator,
                   lo: int, hi: int, column_share: float = 0.75
                   ) -> np.ndarray:
    """``column_share`` of the queries drawn from the column, the rest
    uniform integers in [lo, hi]."""
    from_col = keys[r.integers(0, keys.shape[0], size)]
    uniform = r.integers(lo, hi, size, endpoint=True).astype(np.float64)
    return np.where(r.random(size) < column_share, from_col, uniform)


def insert_keys(keys: np.ndarray, size: int, r: np.random.Generator,
                lo: int, hi: int, copy_share: float = 0.75) -> np.ndarray:
    """``copy_share`` copies of column keys (duplicate runs grow), the rest
    uniform integers in [lo, hi]."""
    return column_queries(keys, size, r, lo, hi, copy_share)
