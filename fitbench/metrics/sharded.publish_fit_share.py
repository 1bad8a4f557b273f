"""Share of the shards' publishes spent merging and re-fitting their dirty
segments: the ``span.tree.flush`` walls over the ``span.sharded.publish``
walls (each flush lies inside its shard's publish)."""
import numpy as np


def read(run):
    mon = run.monitor
    if mon is None:
        return None
    publish = mon.channel("span.sharded.publish")
    flush = mon.channel("span.tree.flush")
    if not publish.size or not flush.size:
        return None
    total = float(np.sum(publish[:, 1]))
    if total <= 0:
        return None
    return float(np.sum(flush[:, 1])) / total
