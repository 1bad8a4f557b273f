"""Host time a device engine call spends around its copies
(``index/engine.py`` ``_DeviceEngine``): the ``span.engine.stage`` (queries
to an f32 host tensor) and ``span.engine.cast`` (answers to int64 numpy)
walls over the number of engine calls (one ``engine.stage`` row each)."""
import numpy as np


def read(run):
    mon = run.monitor
    if mon is None:
        return None
    stage = mon.channel("span.engine.stage")
    if not stage.size:
        return None
    cast = mon.channel("span.engine.cast")
    wall = np.sum(stage[:, 1]) + (np.sum(cast[:, 1]) if cast.size else 0.0)
    return float(wall) * 1e-6 / stage.shape[0]
