"""Mean wall of a memtable spill (``lsm.spill``: freeze, fit, upload)."""
import numpy as np


def read(run):
    mon = run.monitor
    rows = None if mon is None else mon.channel("lsm.spill")
    if rows is None or not rows.size:
        return None
    return float(np.mean(rows[:, -1])) * 1e-6
