"""IoT-shaped event timestamps (FITing-Tree, Sec. 7.1.1, the IoT data set's
shape): busy weekday daytimes, quiet nights and weekends, over 120 days.

A frozen copy of the rate of the port's ``core.datasets.iot_like``, drawn
in torch on the run's device."""
from __future__ import annotations

from fitbench.keys import STREAM_KEYS, thinned, torch_generator

DAY = 86400.0
DAYS = 120.0
RATE_MAX = 2.05


def rate(torch, t):
    hour = torch.remainder(t, DAY) / 3600.0
    dow = torch.remainder(torch.floor(t / DAY), 7)
    day_part = torch.exp(-0.5 * ((hour - 13.5) / 3.2) ** 2)
    weekday = torch.where(dow < 5, 1.0, 0.15)
    return 0.05 + 2.0 * day_part * weekday


def generate(torch, n: int, seed: int, device):
    gen = torch_generator(torch, seed, STREAM_KEYS, device)
    return thinned(torch, n, rate, DAYS * DAY, RATE_MAX, gen, device)
