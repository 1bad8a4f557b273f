"""Mean fan-in of an LSM read: sources (memtable and runs) on the sampled
``lsm.read_amp`` channel."""
import numpy as np


def read(run):
    mon = run.monitor
    rows = None if mon is None else mon.channel("lsm.read_amp")
    if rows is None or not rows.size:
        return None
    return float(np.mean(rows[:, 0]))
