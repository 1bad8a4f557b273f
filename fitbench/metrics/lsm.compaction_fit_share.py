"""Share of compaction spent fitting the merged run: the walls of the
``span.lsm.fit`` rows at level 1 or deeper (a compaction's output; spills
fit at level 0) over the ``lsm.compaction`` walls."""
import numpy as np


def read(run):
    mon = run.monitor
    if mon is None:
        return None
    compaction = mon.channel("lsm.compaction")
    fit = mon.channel("span.lsm.fit")
    if not compaction.size or not fit.size:
        return None
    total = float(np.sum(compaction[:, -1]))
    if total <= 0:
        return None
    return float(np.sum(fit[fit[:, 2] >= 1, 1])) / total
