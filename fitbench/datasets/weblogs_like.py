"""Weblogs-shaped request timestamps (FITing-Tree, Sec. 7.1.1, the Weblogs
data set's shape): daily, weekly and school-year periodicity over a year.

A frozen copy of the rate of the port's ``core.datasets.weblogs_like``,
drawn in torch on the run's device."""
from __future__ import annotations

import math

from fitbench.keys import STREAM_KEYS, thinned, torch_generator

DAY = 86400.0
DAYS = 365.0
RATE_MAX = 1.8


def rate(torch, t):
    hour = torch.remainder(t, DAY) / 3600.0
    dow = torch.remainder(torch.floor(t / DAY), 7)
    doy = torch.remainder(t / DAY, 365.0)
    diurnal = 0.25 + torch.exp(-0.5 * ((hour - 15.0) / 4.0) ** 2)
    weekly = torch.where(dow < 5, 1.0, 0.45)
    season = 0.5 + 0.5 * torch.cos(2 * math.pi * (doy - 45) / 365.0) ** 2
    return 0.02 + diurnal * weekly * season


def generate(torch, n: int, seed: int, device):
    gen = torch_generator(torch, seed, STREAM_KEYS, device)
    return thinned(torch, n, rate, DAYS * DAY, RATE_MAX, gen, device)
