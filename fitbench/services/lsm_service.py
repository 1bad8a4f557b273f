"""An ingesting column: ``LsmIndexService`` (``index/lsm.py``) with the
configuration's memtable and level fanout, reads behind
``AsyncIndexService`` with no cadence thread; the client publishes."""
from __future__ import annotations

from fitbench.frontdoor import FrontDoor, engine_opts


class Service(FrontDoor):
    def __init__(self, config: dict, keys, device: str, monitor):
        from repro_torch.index import LsmIndexService
        from repro_torch.serve import AsyncIndexService
        svc = LsmIndexService(keys, error=int(config["error"]),
                              backend=config["backend"],
                              memtable_capacity=int(
                                  config["memtable_capacity"]),
                              level_fanout=int(config["level_fanout"]),
                              monitor=monitor, assume_sorted=True,
                              engine_opts=engine_opts(device))
        pipe = AsyncIndexService(svc, publish_interval_s=None, prewarm=False)
        super().__init__(svc, pipe, config["error"])

    def insert_many(self, keys) -> None:
        self.service.insert_many(keys)

    def publish(self) -> None:
        self.pipe.publish()

    def n_live(self) -> int:
        return int(self.service.n_live_keys())

    def columns(self) -> list[tuple]:
        """(sorted keys, segments) of each run a read fans out to (a run
        without keys launches nothing)."""
        return [(r.snapshot.table.keys, r.snapshot.table.n_segments)
                for r in self.service.level_set.runs if r.n_keys]
