"""A writable column on the planner's own path: ``fit.open_index`` with the
configuration's ``FitSpec``, which resolves to FITing-Tree's in-place write
mode (Alg. 4 delta buffers in every segment) over range partitions, a
``ShardedIndexService`` that publishes after each ``publish_every`` pending
inserts.  Reads go through ``AsyncIndexService`` at the plan's flush
threshold with no cadence thread (``cadence=False``): the service alone
publishes, by count, as the configuration's visibility states.  Writes go
to the service.

``columns()`` names no column: the harness's fused-search bytes count each
column against a whole read call, and a routed read hands each shard only
its own queries."""
from __future__ import annotations

from fitbench.frontdoor import FrontDoor, engine_opts


class Service(FrontDoor):
    def __init__(self, config: dict, keys, device: str, monitor):
        from repro_torch.index.fit import FitSpec, open_index
        from repro_torch.serve import AsyncIndexService
        spec = FitSpec(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in config["fit_spec"].items()})
        svc = open_index(keys, spec, assume_sorted=True, monitor=monitor,
                         engine_opts=engine_opts(device))
        try:
            pipe = AsyncIndexService(svc, cadence=False, prewarm=False)
        except TypeError:
            # a front door without the option (an older program) keeps its
            # cadence thread; a read-only cell leaves it nothing to publish
            pipe = AsyncIndexService(svc, prewarm=False)
        super().__init__(svc, pipe, config["error"])

    def insert_many(self, keys) -> None:
        self.service.insert_many(keys)

    def publish(self) -> None:
        self.service.publish()

    def n_live(self) -> int:
        """Keys the installed snapshots hold."""
        return int(sum(s.n_keys for s in self.service.metrics().shards))

    def columns(self) -> list[tuple]:
        return []
