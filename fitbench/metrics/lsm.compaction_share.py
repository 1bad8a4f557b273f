"""Share of the window the compactions took: the sum of the
``lsm.compaction`` walls over the window's seconds."""
import numpy as np


def read(run):
    mon = run.monitor
    rows = None if mon is None else mon.channel("lsm.compaction")
    if rows is None or not rows.size or run.outcome.window_s <= 0:
        return None
    return float(np.sum(rows[:, -1])) * 1e-9 / run.outcome.window_s
