"""The harness's handle on a service behind the port's front door.

Every configuration's service is reached as its users reach it: reads
through ``AsyncIndexService`` (``index/pipeline.py``) -- a request at or
above the flush threshold runs inline on the caller's thread, smaller ones
are coalesced by the flusher -- and writes on the service itself."""
from __future__ import annotations

import numpy as np


def engine_opts(device: str) -> dict | None:
    """Engine placement: the card by default; on the CPU every device
    backend runs its plain torch twin there."""
    if device == "cuda":
        return None
    d = {"device": device}
    return {"cuda": dict(d), "torch-bisect": dict(d), "torch-window": dict(d),
            "dispatch": dict(d)}


class FrontDoor:
    """Reads through the pipeline ``pipe`` over ``service``."""

    def __init__(self, service, pipe, error: int):
        self.service, self.pipe, self.error = service, pipe, int(error)

    def read(self, verb: str, q: np.ndarray) -> np.ndarray:
        if verb == "lookup":
            return self.pipe.lookup(q)
        return self.pipe.search(q, verb)

    def warm(self, sizes: list[int], verbs: list[str],
             column: np.ndarray) -> None:
        """Run each verb once at each call size the window sends, through
        the same entry as the window."""
        for size in sizes:
            q = np.resize(column[:size], size)
            for verb in verbs:
                self.read(verb, q)

    def close(self) -> None:
        self.pipe.close()
