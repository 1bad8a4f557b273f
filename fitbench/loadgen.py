"""The general traffic generator: reads and writes from a mix's parameters.

A mix is found by its name in ``fitbench/traffic/``: ``<mix>.json`` holds
its parameters, and ``<mix>.py``, where there is one, a class ``Load`` that
takes the place of the one here (a subclass, as a rule) for traffic that
the parameters below cannot say: another verb, open-loop arrivals.  A mix
of parameters alone is read by :class:`Load`:

``read``
    One closed-loop client, one call at a time.  ``size``: keys a call.
    ``verbs`` (of ``lookup``, ``left``, ``right``) taken in turn.
    ``keys``: shares of keys drawn from the column (``column``), of uniform
    integers in ``uniform`` [lo, hi] (``"domain"`` is the configuration's
    key domain), and of YCSB's "latest" draw (``latest``): Zipf with
    ``latest_theta`` over the order the records arrived in, the newest
    first, the column's keys (in key order, a log's time order) before
    every insert.  ``pool``: calls made before the window and cycled (a
    call's ``latest`` keys are resolved when it is sent).
``write``
    ``share``: inserts as a share of all keys (YCSB's insert proportion);
    before each read the client inserts what that share has made due.
    Without ``read``, the client inserts in a closed loop, ``batch`` keys
    an ``insert_many``.  ``insert_keys``: copies of column keys
    (``copies``) and uniform integers in ``uniform``, drawn in chunks
    keyed by the seed, so every run of a seed inserts the same stream.
    ``publish_every``: ``publish()`` after each this many inserted keys (a
    number, or a key of the configuration).
``check``
    ``sample``: how many read calls' answers the reference checks, drawn
    from the seed (0: every answer).

Every read call is timed on the host's clock from its issue to its answer.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from fitbench import keys as K
from fitbench import reference, trace

INSERT_CHUNK = 2 ** 16    # insert keys are drawn a chunk at a time
READBACK_KEYS = 2 ** 16


@dataclasses.dataclass
class Observed:
    """One answered read the reference checks: ``w`` writes came before."""
    verb: str
    queries: np.ndarray
    answer: np.ndarray
    w: int


@dataclasses.dataclass
class Outcome:
    t_start: float = 0.0
    t_end: float = 0.0
    read_latency_s: list = dataclasses.field(default_factory=list)
    read_keys: int = 0
    write_keys: int = 0
    attempted: int = 0
    failed: int = 0
    unanswered: int = 0
    errors: list = dataclasses.field(default_factory=list)
    observed: list = dataclasses.field(default_factory=list)
    kernel_calls: list = dataclasses.field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.t_end - self.t_start


class _Reservoir:
    """A uniform sample, drawn from the seed, of the read calls made, plus
    the last one (the one with the most writes behind it)."""

    def __init__(self, size: int, r: np.random.Generator):
        self.size, self.r = size, r
        self.kept: list = []
        self.seen = 0
        self.last = None

    def offer(self, obs: Observed) -> None:
        self.last = obs
        if self.size == 0 or self.seen < self.size:
            self.kept.append(obs)
        else:
            j = int(self.r.integers(0, self.seen + 1))
            if j < self.size:
                self.kept[j] = obs
        self.seen += 1

    def sample(self) -> list:
        out = list(self.kept)
        if self.last is not None and all(o is not self.last for o in out):
            out.append(self.last)
        return out


def _bound(value, domain: int) -> int:
    return domain if value == "domain" else int(value)


class Latest:
    """YCSB's "latest" generator (``SkewedLatestGenerator`` over its
    ``ZipfianGenerator``, Gray et al.'s closed form): ages, 0 the newest,
    Zipf with ``theta`` over the ``n`` records so far; ``zeta(n)`` grows
    with ``n`` as records arrive."""

    def __init__(self, theta: float):
        self.theta = float(theta)
        self.alpha = 1.0 / (1.0 - self.theta)
        self.zeta2 = 1.0 + 0.5 ** self.theta
        self.n, self.zetan = 0, 0.0

    def grow(self, n: int) -> None:
        if n > self.n:
            i = np.arange(self.n + 1, n + 1, dtype=np.float64)
            self.zetan += float(np.sum(i ** -self.theta))
            self.n = n

    def ages(self, u: np.ndarray) -> np.ndarray:
        n, th = self.n, self.theta
        if n < 2:
            return np.zeros(u.shape, np.int64)
        eta = (1.0 - (2.0 / n) ** (1.0 - th)) / (1.0 - self.zeta2 / self.zetan)
        uz = u * self.zetan
        ret = (n * (eta * u - eta + 1.0) ** self.alpha).astype(np.int64)
        ret = np.where(uz < 1.0 + 0.5 ** th, 1, ret)
        ret = np.where(uz < 1.0, 0, ret)
        return np.minimum(ret, n - 1)


class _Records:
    """The column's keys, then every insert in the order it was made: what
    a "latest" read draws from."""

    def __init__(self, column: np.ndarray):
        self.buf = np.array(column, np.float64)
        self.n = column.shape[0]

    def extend(self, keys: np.ndarray) -> None:
        if self.n + keys.size > self.buf.size:
            grown = np.empty(max(2 * self.buf.size, self.n + keys.size))
            grown[:self.n] = self.buf[:self.n]
            self.buf = grown
        self.buf[self.n:self.n + keys.size] = keys
        self.n += keys.size


class Load:
    """The mix bound to one run: its key column, its seed, its service.

    The harness calls ``prepare()`` and ``warm_sizes()`` in set-up,
    ``run()`` for the window, then ``read_back()``, ``history()`` and
    ``expected()`` for the check; ``verbs`` are the read verbs warmed."""

    def __init__(self, mix: dict, config: dict, column: np.ndarray,
                 domain: int, seed: int, seconds: float):
        self.config = config
        self.column, self.domain = column, domain
        self.seed, self.seconds = seed, float(seconds)
        self.read = mix.get("read")
        self.write = mix.get("write")
        self.sample = int((mix.get("check") or {}).get("sample", 0))
        self.verbs = list(self.read["verbs"]) if self.read else []
        self.absent = config["guarantees"].get("lookup_absent")
        self.pool: list = []
        self.inserted: list[np.ndarray] = []     # acknowledged, in order
        self.n_inserted = 0
        self._pending = np.empty(0)       # drawn, not yet inserted
        self._n_chunks = 0

    # ----------------------------------------------------------- set-up
    def prepare(self) -> None:
        """Make every read call that can be made before the window."""
        if self.read is None:
            return
        r = K.rng(self.seed, K.STREAM_READS)
        self.pool = [self._template(r) for _ in range(int(self.read["pool"]))]
        self.records = _Records(self.column)
        self.latest = Latest(float(self.read.get("latest_theta", 0.99)))
        self.latest.grow(self.records.n)

    def warm_sizes(self) -> list[int]:
        """The call sizes the window will send (the service warms these and
        no others)."""
        return [int(self.read["size"])] if self.read else []

    def _template(self, r: np.random.Generator) -> tuple:
        """One call: the keys drawn before the window, and the places and
        uniform draws of its ``latest`` keys."""
        size = int(self.read["size"])
        shares = self.read["keys"]
        col, uni = shares.get("column", 0.0), shares.get("uniform", 0.0)
        u = r.random(size)
        cat = np.where(u < col, 0, np.where(u < col + uni, 1, 2))
        ulo, uhi = self.read.get("uniform", [0, "domain"])
        col_vals = self.column[r.integers(0, self.column.shape[0], size)]
        uni_vals = r.integers(_bound(ulo, self.domain),
                              _bound(uhi, self.domain), size,
                              endpoint=True).astype(np.float64)
        q = np.where(cat == 1, uni_vals, col_vals)
        latest = np.flatnonzero(cat == 2)
        return q, latest, r.random(latest.size)

    def _resolve(self, tpl: tuple) -> np.ndarray:
        """The call's keys, its ``latest`` ones among the records so far."""
        q, latest, u = tpl
        if not latest.size:
            return q
        q = q.copy()
        rec = self.records
        q[latest] = rec.buf[rec.n - 1 - self.latest.ages(u)]
        return q

    def insert_keys(self, n: int) -> np.ndarray:
        """The next ``n`` keys of the seed's insert stream."""
        w = self.write
        lo, hi = w["insert_keys"]["uniform"]
        while self._pending.size < n:
            r = K.rng(self.seed, K.STREAM_WRITES, self._n_chunks)
            self._n_chunks += 1
            self._pending = np.concatenate([self._pending, K.insert_keys(
                self.column, INSERT_CHUNK, r, _bound(lo, self.domain),
                _bound(hi, self.domain), float(w["insert_keys"]["copies"]))])
        out, self._pending = self._pending[:n], self._pending[n:]
        return out

    def _publish_every(self) -> int | None:
        p = self.write.get("publish_every") if self.write else None
        if isinstance(p, str):
            return int(self.config[p])
        return None if p is None else int(p)

    # ------------------------------------------------------------ window
    def issue(self, service, verb: str, q: np.ndarray) -> np.ndarray:
        """One read call on the service."""
        return service.read(verb, q)

    def run(self, torch, service, traced: bool) -> Outcome:
        out = Outcome()
        reservoir = _Reservoir(self.sample, K.rng(self.seed, K.STREAM_SAMPLE))
        self._writer = _Writer(torch, service, self._publish_every(), traced,
                               self)
        with trace.span(torch, trace.WINDOW, traced):
            if self.read is None:
                self._closed_loop_writes(out)
            else:
                self._one_client(torch, service, out, reservoir, traced)
        out.observed.extend(reservoir.sample())
        out.write_keys = self.n_inserted
        out.attempted += self._writer.calls
        return out

    def _one_client(self, torch, service, out: Outcome, reservoir,
                    traced: bool) -> None:
        share = float(self.write["share"]) if self.write else 0.0
        ratio = share / (1.0 - share)
        i = 0
        out.t_start = time.perf_counter()
        t_stop = out.t_start + self.seconds
        t_end = out.t_start
        while time.perf_counter() < t_stop:
            due = int(out.read_keys * ratio) - self.n_inserted
            if due > 0:
                self._writer.insert(self.insert_keys(due))
            q = self._resolve(self.pool[i % len(self.pool)])
            verb = self.verbs[i % len(self.verbs)]
            if traced:
                out.kernel_calls.append((service.columns(), q))
            out.attempted += 1
            i += 1
            t0 = time.perf_counter()
            try:
                with trace.span(torch, trace.READ + verb, traced):
                    ans = self.issue(service, verb, q)
            except Exception as exc:       # counted; the run is not correct
                out.failed += 1
                out.unanswered += 1
                out.errors.append(repr(exc)[:500])
                t_end = time.perf_counter()
                continue
            t_end = time.perf_counter()
            out.read_latency_s.append(t_end - t0)
            out.read_keys += q.size
            reservoir.offer(Observed(verb, q, ans, self.n_inserted))
        out.t_end = max(t_end, out.t_start)

    def _closed_loop_writes(self, out: Outcome) -> None:
        batch = int(self.write["batch"])
        out.t_start = time.perf_counter()
        t_stop = out.t_start + self.seconds
        while time.perf_counter() < t_stop:
            self._writer.insert(self.insert_keys(batch))
        out.t_end = time.perf_counter()

    def acknowledged(self, keys: np.ndarray) -> None:
        """``keys`` were inserted: their call returned."""
        self.inserted.append(keys)
        self.n_inserted += keys.size
        if self.read is not None:
            self.records.extend(keys)
            self.latest.grow(self.records.n)

    # ----------------------------------------------- after the window
    def history(self) -> reference.History:
        """The column and every acknowledged insert, in order."""
        ins = np.concatenate(self.inserted) if self.inserted else None
        return reference.History(self.column, ins)

    def read_back(self, service) -> dict | None:
        """Where the mix writes: every verb read back through the service
        after the window -- column keys, uniform integers and inserted
        keys -- and the live count."""
        if self.write is None:
            return None
        r = K.rng(self.seed, K.STREAM_READBACK)
        ins = np.concatenate(self.inserted) if self.inserted else \
            np.empty(0)
        third = READBACK_KEYS // 3
        parts = [self.column[r.integers(0, self.column.shape[0], third)],
                 r.integers(0, self.domain, third, endpoint=True)
                 .astype(np.float64)]
        if ins.size:
            parts.append(ins[r.integers(0, ins.size,
                                        READBACK_KEYS - 2 * third)])
        q = np.concatenate(parts)
        return {"queries": q, "n_live": service.n_live(),
                "answers": {v: service.read(v, q)
                            for v in ("lookup", "left", "right")}}

    def expected(self, live: np.ndarray, q: np.ndarray, verb: str
                 ) -> np.ndarray:
        """The reference's answers to ``verb`` over the live keys."""
        return reference.ranks(live, q, verb, self.absent)


class _Writer:
    """Inserts into the service, publishing after each ``publish_every``
    inserted keys, and tells the load what was acknowledged."""

    def __init__(self, torch, service, publish_every, traced: bool,
                 load: Load):
        self.torch, self.service, self.traced = torch, service, traced
        self.publish_every = publish_every
        self.load = load
        self.since_publish = 0
        self.calls = 0

    def insert(self, keys: np.ndarray) -> None:
        a = 0
        while a < keys.size:
            take = keys.size - a
            if self.publish_every:
                take = min(take, self.publish_every - self.since_publish)
            part = keys[a:a + take]
            with trace.span(self.torch, trace.WRITE + "insert_many",
                            self.traced):
                self.service.insert_many(part)
            self.calls += 1
            self.load.acknowledged(part)
            a += take
            self.since_publish += take
            if self.publish_every and \
                    self.since_publish >= self.publish_every:
                with trace.span(self.torch, trace.WRITE + "publish",
                                self.traced):
                    self.service.publish()
                self.calls += 1
                self.since_publish = 0
