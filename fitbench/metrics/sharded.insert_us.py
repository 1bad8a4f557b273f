"""Host time a key takes in the sharded service's batch insert
(``index/sharded.py`` ``insert_many``, ``core/tree.py`` Alg. 4): the
``span.sharded.insert`` walls (routing and the delta-buffer work; any
auto-publish lies outside them) over the keys they tag, in us."""
import numpy as np


def read(run):
    mon = run.monitor
    rows = None if mon is None else mon.channel("span.sharded.insert")
    if rows is None or not rows.size or np.sum(rows[:, 2]) <= 0:
        return None
    return float(np.sum(rows[:, 1])) * 1e-3 / float(np.sum(rows[:, 2]))
