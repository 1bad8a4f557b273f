"""Learned-index-backed training data pipeline (port of
``repro.data.pipeline``: the reference's host numpy code on the port's own
``core.segmentation`` and ``core.cost_model``; it imports no torch).

A tokenized corpus is one long token stream plus a sorted array of document
boundary offsets (cumulative token counts) -- exactly the monotone step
function of the paper's Fig. 1.  Addressing *global token position ->
(document, offset)* is a predecessor query; instead of a dense 8-bytes-per-doc
offset table (8 GB/host at 1B docs), a FITing-tree over the boundaries gives
bounded-probe lookups from a few-MB segment table (error picked by the Sec. 6
cost model against a latency budget).

The pipeline is deterministic (seeded affine permutation over samples),
host-shardable (host h takes sample indices == h mod n_hosts), and
checkpointable (state == step); a background thread prefetches batches.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np

from repro_torch.core.cost_model import CostParams, \
    choose_error_for_latency, learn_segments_fn
from repro_torch.core.segmentation import Segments, shrinking_cone


@dataclasses.dataclass
class Corpus:
    tokens: np.ndarray        # (N,) int32 -- the concatenated token stream
    boundaries: np.ndarray    # (D+1,) int64 -- cumulative doc offsets, [0]=0

    @property
    def n_tokens(self) -> int:
        return int(self.tokens.shape[0])

    @property
    def n_docs(self) -> int:
        return int(self.boundaries.shape[0] - 1)


def synthetic_corpus(n_tokens: int = 2_000_000, vocab: int = 32_000,
                     mean_doc: float = 600.0, seed: int = 0) -> Corpus:
    """Zipf tokens, lognormal doc lengths -- shaped like a web corpus."""
    rng = np.random.default_rng(seed)
    tokens = (rng.zipf(1.3, size=n_tokens).astype(np.int64) % (vocab - 2)) + 2
    lengths = np.maximum(8, rng.lognormal(np.log(mean_doc), 1.0,
                                          size=max(8, int(n_tokens * 2 / mean_doc)))
                         .astype(np.int64))
    cum = np.cumsum(lengths)
    cut = int(np.searchsorted(cum, n_tokens))
    boundaries = np.concatenate([[0], cum[:cut], [n_tokens]])
    boundaries = np.unique(boundaries[boundaries <= n_tokens])
    return Corpus(tokens=tokens.astype(np.int32), boundaries=boundaries)


class DocIndex:
    """FITing-tree over document boundaries: position -> (doc id, offset).

    ``error`` defaults to the Sec. 6 cost-model choice for a 2us probe budget;
    the probe is interpolation + a <=2*error-wide local search (one cache/DMA
    window), never a full binary search over D documents."""

    def __init__(self, boundaries: np.ndarray, error: int | None = None):
        self.boundaries = np.asarray(boundaries, np.float64)
        if error is None:
            cands = [64, 256, 1024, 4096]
            fn = learn_segments_fn(self.boundaries, cands, sample=None)
            error = choose_error_for_latency(2_000.0, fn, cands,
                                             CostParams(c_ns=100.0)) or 256
        self.error = int(error)
        self.segs: Segments = shrinking_cone(self.boundaries, self.error)

    def index_size_bytes(self) -> int:
        return self.segs.n_segments * 24

    def doc_of(self, pos: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized predecessor query with the bounded window (Alg. 3)."""
        pos = np.asarray(pos, np.float64)
        pred = self.segs.predict(pos)
        n = self.boundaries.shape[0]
        lo = np.clip(pred.astype(np.int64) - self.error, 0, n - 1)
        hi = np.clip(pred.astype(np.int64) + self.error + 2, 1, n)
        # bounded branchless bisect over the window
        steps = int(np.ceil(np.log2(2 * self.error + 3)))
        for _ in range(steps):
            mid = (lo + hi) // 2
            go = self.boundaries[np.minimum(mid, n - 1)] <= pos
            lo = np.where(go & (lo < hi), mid + 1, lo)
            hi = np.where(go, hi, mid)
        doc = np.maximum(lo - 1, 0)
        off = pos.astype(np.int64) - self.boundaries[doc].astype(np.int64)
        return doc.astype(np.int64), off


def shard_rows(batch: int, shard: tuple[int, int] = (0, 1),
               microbatches: int = 1) -> np.ndarray:
    """The rows of a global batch of ``batch`` rows that data-parallel
    shard ``i`` of ``n`` holds: the i-th of n equal blocks of each of the
    ``microbatches`` consecutive microbatches, in order.  A shard's k-th
    local microbatch is then its block of the global k-th, so which rows
    meet in a microbatch does not depend on the number of ranks."""
    i, n = shard
    if batch % (microbatches * n):
        raise ValueError(f"a batch of {batch} rows in {microbatches} "
                         f"microbatches does not split over {n} shards")
    per = batch // (microbatches * n)
    starts = np.arange(microbatches) * (batch // microbatches) + i * per
    return (starts[:, None] + np.arange(per)[None]).reshape(-1)


@dataclasses.dataclass
class PipelineConfig:
    seq_len: int = 1024
    batch_size: int = 8            # host-local
    n_hosts: int = 1
    host_id: int = 0
    seed: int = 1234
    prefetch: int = 2


class DataPipeline:
    """Deterministic, resumable sample iterator over a Corpus."""

    def __init__(self, corpus: Corpus, cfg: PipelineConfig,
                 doc_index: DocIndex | None = None):
        self.corpus = corpus
        self.cfg = cfg
        self.doc_index = doc_index or DocIndex(corpus.boundaries)
        self.n_samples = (corpus.n_tokens - 1) // (cfg.seq_len + 1)
        # odd multiplier -> affine permutation over Z_n (deterministic shuffle)
        rng = np.random.default_rng(cfg.seed)
        self.mult = int(rng.integers(1, self.n_samples // 2) * 2 + 1)
        self.offset = int(rng.integers(0, self.n_samples))
        self._q: queue.Queue = queue.Queue(maxsize=cfg.prefetch)
        self._thread = None
        self._stop = threading.Event()

    # ------------------------------------------------------------ addressing
    def _sample_ids(self, step: int) -> np.ndarray:
        c = self.cfg
        base = step * c.batch_size * c.n_hosts + c.host_id * c.batch_size
        idx = (base + np.arange(c.batch_size)) % self.n_samples
        return (idx * self.mult + self.offset) % self.n_samples

    def batch_at(self, step: int, shard: tuple[int, int] = (0, 1),
                 microbatches: int = 1) -> dict:
        """(B, T+1) tokens + (B,) doc ids of each window start (metadata).

        ``shard=(i, n)``: only a data-parallel rank's rows of the global
        batch (:func:`shard_rows`)."""
        c = self.cfg
        ids = self._sample_ids(step)[shard_rows(c.batch_size, shard,
                                                microbatches)]
        starts = ids * (c.seq_len + 1)
        rows = starts[:, None] + np.arange(c.seq_len + 1)[None]
        toks = self.corpus.tokens[rows]
        docs, offs = self.doc_index.doc_of(starts)
        return {"tokens": toks.astype(np.int32), "docs": docs, "offsets": offs}

    # ------------------------------------------------------------- prefetch
    def start(self, from_step: int):
        def worker():
            s = from_step
            while not self._stop.is_set():
                try:
                    self._q.put((s, self.batch_at(s)), timeout=0.2)
                    s += 1
                except queue.Full:
                    continue
        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        while True:
            yield self._q.get()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)

    # ------------------------------------------------------------ checkpoint
    def state_dict(self) -> dict:
        return {"seed": self.cfg.seed, "mult": self.mult,
                "offset": self.offset}

    def check_state(self, st: dict):
        assert st["mult"] == self.mult and st["offset"] == self.offset, \
            "pipeline permutation mismatch: corpus/seed changed across resume"
