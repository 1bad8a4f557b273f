"""The space cost of epochs: the segments of the shards the window
published, after each one's last publish, over their segments before its
first, from the ``span.sharded.publish`` tags (shard, re-fit, segments
before, segments after)."""
import numpy as np


def read(run):
    mon = run.monitor
    rows = None if mon is None else mon.channel("span.sharded.publish")
    if rows is None or not rows.size:
        return None
    before, after = {}, {}
    for shard, seg_before, seg_after in rows[:, [2, 4, 5]]:
        before.setdefault(shard, seg_before)
        after[shard] = seg_after
    first = sum(before.values())
    if first <= 0:
        return None
    return float(sum(after.values()) / first)
