"""Share of the window the shards' publishes took: the
``span.sharded.publish`` walls (one shard's flush, snapshot and install)
over the window's seconds."""
import numpy as np


def read(run):
    mon = run.monitor
    rows = None if mon is None else mon.channel("span.sharded.publish")
    if rows is None or not rows.size or run.outcome.window_s <= 0:
        return None
    return float(np.sum(rows[:, 1])) * 1e-9 / run.outcome.window_s
