"""YCSB D against a service that shows inserts by epochs: ``mix.json``'s
reads and inserts, with nothing published by the client.

The configuration states the visibility: the service publishes every shard
after each ``plan.publish_every`` acknowledged inserts, and an insert is
seen by every read that starts after the publish that follows it.  With
one client and the shard cuts fixed (``auto_rebalance`` off), a read that
starts after ``n`` acknowledged inserts sees exactly the first
``publish_every * (n // publish_every)`` of them, and the reference answers
it over the column plus those.  A service that publishes late, early or
not at all answers otherwise, and the check counts it wrong.  The insert
share is counted over every acknowledged key; the read-back follows a
final ``publish()``.
"""
from __future__ import annotations

from fitbench import loadgen


class Load(loadgen.Load):
    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.publish_every = int(self.config["plan"]["publish_every"])

    def visible(self, n_inserted: int) -> int:
        """Inserts a read sees that starts after ``n_inserted`` of them."""
        return self.publish_every * (n_inserted // self.publish_every)

    def run(self, torch, service, traced: bool) -> loadgen.Outcome:
        out = super().run(torch, service, traced)
        for o in out.observed:       # o.w: inserts acknowledged before it
            o.w = self.visible(o.w)
        return out

    def read_back(self, service) -> dict | None:
        service.publish()
        return super().read_back(service)
