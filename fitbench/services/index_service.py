"""A read-only column: ``IndexService`` (``serve/index_service.py``) on a
backend the configuration names, behind ``AsyncIndexService`` with the
configuration's flush threshold and deadline and no cadence thread."""
from __future__ import annotations

from fitbench.frontdoor import FrontDoor, engine_opts


class Service(FrontDoor):
    def __init__(self, config: dict, keys, device: str, monitor):
        from repro_torch.serve import AsyncIndexService, IndexService
        svc = IndexService(keys, error=int(config["error"]),
                           backend=config["backend"], monitor=monitor,
                           assume_sorted=True,
                           engine_opts=engine_opts(device))
        door = config["front_door"]
        threshold = door["flush_threshold"]
        if threshold == "large_min":       # the dispatch tiers' crossing
            threshold = svc.handle.engine(config["backend"]).large_min
        pipe = AsyncIndexService(svc, flush_threshold=int(threshold),
                                 max_wait_us=float(door["max_wait_us"]),
                                 publish_interval_s=None, prewarm=False)
        super().__init__(svc, pipe, config["error"])

    def columns(self) -> list[tuple]:
        """(sorted keys, segments) of each column one read searches."""
        table = self.service.handle.current().table
        return [(table.keys, table.n_segments)]
