"""Host time of a search call's routing in the sharded service
(``index/sharded.py`` ``_search_view``): the ``span.service.route`` and
``span.service.scatter`` walls over the number of routed calls (one
``service.route`` row each)."""
import numpy as np


def read(run):
    mon = run.monitor
    if mon is None:
        return None
    route = mon.channel("span.service.route")
    if not route.size:
        return None
    scatter = mon.channel("span.service.scatter")
    wall = np.sum(route[:, 1]) + (np.sum(scatter[:, 1]) if scatter.size
                                  else 0.0)
    return float(wall) * 1e-6 / route.shape[0]
