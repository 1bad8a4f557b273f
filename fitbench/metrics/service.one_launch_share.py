"""Share of the read calls over more than one shard that the service
answered with one engine call (``index/sharded.py`` ``_routed``): of the
``span.service.route`` rows whose first tag (the view's shards) is above 1,
those whose second tag (the read's engine calls) is 1.  None where the rows
carry no second tag, as a service that routes each shard's queries apart
writes them, or where no read spanned more than one shard."""
import numpy as np


def read(run):
    mon = run.monitor
    rows = None if mon is None else mon.channel("span.service.route")
    if rows is None or not rows.size or rows.shape[1] < 4:
        return None
    many = rows[rows[:, 2] > 1]
    if not many.shape[0]:
        return None
    return float(np.count_nonzero(many[:, 3] == 1)) / many.shape[0]
