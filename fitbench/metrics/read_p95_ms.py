"""The 95th percentile, over every read call answered in the window, of its
time from issue to answer on the host's clock."""
import numpy as np


def read(run):
    lat = run.outcome.read_latency_s
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat), 95)) * 1e3
