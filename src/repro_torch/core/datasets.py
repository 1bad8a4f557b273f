"""Synthetic datasets shaped like the paper's evaluation data (Sec. 7.1.1).

Port of ``repro.core.datasets`` (host numpy, copied; same keys for the same
seed).

The paper's Weblogs / IoT / Maps datasets are not redistributable, so we generate
synthetic keys with the same *distributional shape*:

  * ``iot_like``      -- event timestamps with strong diurnal + weekend periodicity
                         (inhomogeneous Poisson; Fig. 1 / Fig. 8 "IoT" shape).
  * ``weblogs_like``  -- request timestamps with multi-scale periodicity
                         (daily x weekly x seasonal rate modulation).
  * ``maps_like``     -- longitudes: near-linear with density bumps (cities).
  * ``step_data``     -- the adversarial fixed-step function of Sec. 7.2 / Fig. 9a.
  * ``lognormal_keys``/ ``uniform_keys`` / ``zipf_gaps`` -- classic learned-index
                         microbenchmark distributions.

All return a sorted float64 array of keys (duplicates possible where noted).
``non_linearity_ratio`` implements the Fig. 8 metric.
"""
from __future__ import annotations

import numpy as np

from .segmentation import shrinking_cone

DAY = 86400.0


def _inhomogeneous_poisson(n: int, rate_fn, t_end: float, rng: np.random.Generator,
                           rate_max: float) -> np.ndarray:
    """Thinning sampler; returns ~n sorted event times in [0, t_end]."""
    # Draw ~25% extra candidates, thin, then trim/top-up deterministically.
    m = int(n * 1.3) + 64
    out = np.empty(0, np.float64)
    while out.shape[0] < n:
        cand = np.sort(rng.uniform(0.0, t_end, size=m))
        keep = rng.uniform(0.0, rate_max, size=m) < rate_fn(cand)
        out = np.concatenate([out, cand[keep]])
        m = max(1024, int((n - out.shape[0]) * 2.5))
    out = np.sort(out)
    idx = np.linspace(0, out.shape[0] - 1, n).astype(np.int64)
    return out[idx]


def iot_like(n: int = 1_000_000, days: float = 120.0, seed: int = 0) -> np.ndarray:
    """Diurnal + weekend periodicity: busy 9am-6pm weekdays, quiet nights/weekends."""
    rng = np.random.default_rng(seed)
    t_end = days * DAY

    def rate(t):
        hour = (t % DAY) / 3600.0
        dow = (t // DAY) % 7
        day_part = np.exp(-0.5 * ((hour - 13.5) / 3.2) ** 2)  # daytime bump
        weekday = np.where(dow < 5, 1.0, 0.15)
        return 0.05 + 2.0 * day_part * weekday

    return _inhomogeneous_poisson(n, rate, t_end, rng, rate_max=2.05)


def weblogs_like(n: int = 1_000_000, days: float = 365.0, seed: int = 1) -> np.ndarray:
    """Multi-scale periodicity: diurnal x weekly x school-year seasonality."""
    rng = np.random.default_rng(seed)
    t_end = days * DAY

    def rate(t):
        hour = (t % DAY) / 3600.0
        dow = (t // DAY) % 7
        doy = (t / DAY) % 365.0
        diurnal = 0.25 + np.exp(-0.5 * ((hour - 15.0) / 4.0) ** 2)
        weekly = np.where(dow < 5, 1.0, 0.45)
        season = 0.5 + 0.5 * (np.cos(2 * np.pi * (doy - 45) / 365.0) ** 2)
        return 0.02 + diurnal * weekly * season

    return _inhomogeneous_poisson(n, rate, t_end, rng, rate_max=1.8)


def maps_like(n: int = 1_000_000, seed: int = 2) -> np.ndarray:
    """Longitude-like: mostly uniform with gaussian 'city' clusters; near-linear CDF."""
    rng = np.random.default_rng(seed)
    n_uniform = int(n * 0.72)
    base = rng.uniform(-180.0, 180.0, size=n_uniform)
    n_city = n - n_uniform
    centers = rng.uniform(-170.0, 170.0, size=40)
    weights = rng.dirichlet(np.ones(40))
    assign = rng.choice(40, size=n_city, p=weights)
    cities = centers[assign] + rng.normal(0.0, 0.8, size=n_city)
    keys = np.clip(np.concatenate([base, cities]), -180.0, 180.0)
    return np.sort(keys)


def step_data(n: int = 1_000_000, step: int = 100, jump: float = 1e4,
              within: float = 1.0, seed: int = 3) -> np.ndarray:
    """Sec. 7.2 worst case: groups of ``step`` positions whose keys sit in a tight
    cluster, followed by a large key jump (Fig. 9a). error < step => one segment
    per step; error >= step => a single segment suffices."""
    rng = np.random.default_rng(seed)
    n_steps = (n + step - 1) // step
    bases = np.arange(n_steps, dtype=np.float64) * jump
    offs = np.sort(rng.uniform(0.0, within, size=(n_steps, step)), axis=1)
    keys = (bases[:, None] + offs).reshape(-1)[:n]
    return keys


def lognormal_keys(n: int = 1_000_000, sigma: float = 2.0, seed: int = 4) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.sort(rng.lognormal(mean=0.0, sigma=sigma, size=n) * 1e6)


def uniform_keys(n: int = 1_000_000, lo: float = 0.0, hi: float = 1e9,
                 seed: int = 5) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.sort(rng.uniform(lo, hi, size=n))


def zipf_gaps(n: int = 1_000_000, a: float = 1.4, seed: int = 6) -> np.ndarray:
    """Keys whose successive gaps are Zipf-distributed (heavy-tailed bursts)."""
    rng = np.random.default_rng(seed)
    gaps = rng.zipf(a, size=n).astype(np.float64)
    return np.cumsum(gaps)


DATASETS = {
    "iot": iot_like,
    "weblogs": weblogs_like,
    "maps": maps_like,
    "lognormal": lognormal_keys,
    "uniform": uniform_keys,
    "zipf": zipf_gaps,
}


def non_linearity_ratio(keys: np.ndarray, error: int) -> float:
    """Fig. 8 metric: S_e normalized by the worst case #segments at that error.

    Worst case = a dataset of the same size with periodicity equal to the error,
    i.e. ceil(n / (error+1)) segments (Theorem 3.1 lower bound on segment size).
    """
    segs = shrinking_cone(keys, error)
    n = keys.shape[0]
    worst = np.ceil(n / (error + 1.0))
    return segs.n_segments / worst
